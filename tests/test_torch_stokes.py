"""Parity of the port's mixed Stokes family (navier_stokes_tpu_torch
``models.stokes``, ``models.discretizations``) with the JAX package.

Both packages build the same systems from the same inputs: the channel with
cylinder at maxh 0.3 (420 triangles), every mixed pair of the catalog
(Taylor-Hood 2 and 3, P1nc-P0, P2-P0, P2-P1, P2+-P1, mini), the parabolic
inflow and the reference's volume force; the port on the CPU, where its
wrappers take the kernels' plain versions.  Random inputs come from numpy
generators with fixed seeds.  Tolerances:

* host tables (bases, dof tables, masks, element forms of the new spaces,
  the force vector, u_bc): 1e-13;
* A, B, B^T, preA and preM applies: 1e-12 (relative, 2-norm);
* Bramble-Pasciak CG (v1 and the optimized v2) with the JAX package's k
  and MINRES: equal counts, the first 30 entries of the error histories
  within 1e-8 (relative; past them roundoff parts the histories, see
  ``_histories_match``), solutions within 1e-8;
* the sweep harness: both packages' CSVs hold the same header, the same
  rows and the same values but ``solver_time`` and ``error`` (the errors
  as the histories above).
"""

import csv
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mcs2d_solve import (
    _rel,
    one_torch_thread,  # noqa: F401  (the module's thread limits)
)

from navier_stokes_tpu.fem import reference as jref
from navier_stokes_tpu.fem import spaces as jspaces
from navier_stokes_tpu.mesh.generators import (
    channel_with_cylinder_mesh as jax_channel,
)
from navier_stokes_tpu.models import discretizations as jdisc
from navier_stokes_tpu.models import stokes as jst
from navier_stokes_tpu.ops import assembly as jasm
from navier_stokes_tpu.solvers.bpcg import bp_scale_factor as jax_bp_scale
from navier_stokes_tpu_torch.fem import reference as tref
from navier_stokes_tpu_torch.fem import spaces as tspaces
from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh
from navier_stokes_tpu_torch.models import discretizations as tdisc
from navier_stokes_tpu_torch.models import stokes as tst
from navier_stokes_tpu_torch.ops import assembly as tasm
from navier_stokes_tpu_torch.utils.profiling import maybe_profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAXH = 0.3
TOL = 1e-7
HEAD = 30  # the iterations over which the error histories are compared

# catalog name -> (factory name, its arguments)
MIXED = {
    "TH2": ("taylor_hood", (2,)),
    "TH3": ("taylor_hood", (3,)),
    "P1nc-P0": ("P1_nonconforming_velocity_constant_pressure", ()),
    "P2-P0": ("P2_velocity_constant_pressure", ()),
    "P2-P1": ("P2_velocity_linear_pressure", ()),
    "P2+-P1": ("P2_velocity_with_cubic_bubbles_linear_pressure", ()),
    "mini": ("mini", ()),
}


def _disc(pkg, name):
    fname, args = MIXED[name]
    return getattr(pkg, fname)(*args)


@pytest.fixture(scope="module")
def meshes():
    return jax_channel(MAXH), channel_with_cylinder_mesh(MAXH)


@pytest.fixture(scope="module")
def systems(meshes):
    """(JAX system, port system) per (pair, a_pre), built on first use."""
    cache = {}

    def get(name, a_pre="jacobi"):
        if (name, a_pre) not in cache:
            jm, tm = meshes
            js = jst.build_stokes_system(
                jm, _disc(jdisc, name)[0], uin=jst.default_inlet_profile(),
                a_pre=a_pre)
            ts = tst.build_stokes_system(
                tm, _disc(tdisc, name)[0], uin=tst.default_inlet_profile(),
                a_pre=a_pre, device="cpu")
            cache[name, a_pre] = (js, ts)
        return cache[name, a_pre]

    return get


def _apply_both(fj, ft, x):
    return (np.asarray(fj(jnp.asarray(x))),
            ft(torch.from_numpy(x)).numpy())


# -- bases, spaces and forms of the new elements ------------------------------


@pytest.mark.parametrize("which", ["CR", "bubble1", "bubble2"])
def test_new_bases_match_jax(which):
    make = {"CR": lambda m: m.crouzeix_raviart_triangle(),
            "bubble1": lambda m: m.bubble_enriched_triangle(1),
            "bubble2": lambda m: m.bubble_enriched_triangle(2)}[which]
    bj, bt = make(jref), make(tref)
    for f in ("dim", "order", "n_basis", "n_vertex", "n_edge", "n_face",
              "n_cell", "name", "nodal"):
        assert getattr(bj, f) == getattr(bt, f), f
    np.testing.assert_array_equal(bj.nodes, bt.nodes)
    pts = np.random.default_rng(3).random((17, 2)) * 0.5
    for a, b in zip(bj.tabulate(pts), bt.tabulate(pts)):
        assert np.abs(a - b).max() <= 1e-13


SPACES = {"H1b1": lambda m, s: m.H1_with_bubble(s, 1, "wall|inlet|cyl"),
          "H1b2": lambda m, s: m.H1_with_bubble(s, 2, "wall|inlet|cyl"),
          "CR": lambda m, s: m.Nonconforming(s, "wall|inlet|cyl")}


@pytest.mark.parametrize("which", list(SPACES))
def test_new_spaces_match_jax(meshes, which):
    jm, tm = meshes
    sj, st_ = SPACES[which](jspaces, jm), SPACES[which](tspaces, tm)
    assert sj.ndof == st_.ndof and sj.name == st_.name
    np.testing.assert_array_equal(sj.element_dofs, st_.element_dofs)
    np.testing.assert_array_equal(sj.free_mask, st_.free_mask)
    f = jst.default_inlet_profile()
    a = sj.interpolate_boundary(lambda p: f(p)[:, 0], "inlet")
    b = st_.interpolate_boundary(lambda p: f(p)[:, 0], "inlet")
    assert np.abs(a - b).max() <= 1e-13


@pytest.mark.parametrize("which", list(SPACES))
def test_forms_on_new_spaces_match_jax(meshes, which):
    """make_tables and the element forms of ops/assembly (stiffness, mass,
    divergence against a P0 / P1 pressure, linear form) on the new
    spaces."""
    jm, tm = meshes
    sj, st_ = SPACES[which](jspaces, jm), SPACES[which](tspaces, tm)
    qj, qt = jspaces.L2(jm, 1), tspaces.L2(tm, 1)
    qd = 2 * max(sj.order, 1)
    tj, tt = jasm.make_tables(sj, qd), tasm.make_tables(st_, qd,
                                                        device="cpu")
    pj, pt = jasm.make_tables(qj, qd), tasm.make_tables(qt, qd, device="cpu")
    fq = np.random.default_rng(5).standard_normal(tt.qpts.shape[:2])
    pairs = [
        (jasm.stiffness_local(tj), tasm.stiffness_local(tt)),
        (jasm.mass_local(tj), tasm.mass_local(tt)),
        (jasm.divergence_local(pj, tj), tasm.divergence_local(pt, tt)),
        (jasm.linear_form_local(tj, jnp.asarray(fq)),
         tasm.linear_form_local(tt, torch.from_numpy(fq))),
        (tj.qpts, tt.qpts),
    ]
    for a, b in pairs:
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-13 * max(np.abs(a).max(), 1.0)


def test_assemble_csr_rect_matches_jax():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((40, 3, 5))
    rd = rng.integers(0, 30, (40, 3))
    cd = rng.integers(0, 50, (40, 5))
    mj = jasm.assemble_csr_rect(a, rd, cd, 30, 50)
    mt = tasm.assemble_csr_rect(a, rd, cd, 30, 50)
    assert mt.shape == (30, 50)
    assert np.abs((mj - mt).toarray()).max() <= 1e-14


def test_catalog_is_complete_and_matches_jax(meshes):
    """All nine factories of the catalog, with JAX's orders and space
    sizes."""
    jm, tm = meshes
    factories = [("taylor_hood", (2,)), ("taylor_hood", (3,)),
                 ("P1_nonconforming_velocity_constant_pressure", ()),
                 ("P2_velocity_constant_pressure", ()),
                 ("P2_velocity_linear_pressure", ()),
                 ("P2_velocity_with_cubic_bubbles_linear_pressure", ()),
                 ("mini", ()), ("bdm_hybrid", (2, 10)),
                 ("rt_hybrid", (1, 10)), ("bdm_hybrid", (2, 10, True))]
    for fname, args in factories:
        dj, oj = getattr(jdisc, fname)(*args)
        dt, ot = getattr(tdisc, fname)(*args)
        assert oj == ot
        Vj, Qj = dj(jm, "wall|inlet|cyl")
        Vt, Qt = dt(tm, "wall|inlet|cyl")
        assert (Vj.ndof, Qj.ndof) == (Vt.ndof, Qt.ndof), fname
        np.testing.assert_array_equal(Vj.free_mask, Vt.free_mask)
    dj, oj = jdisc.hcurldiv(2)
    dt, ot = tdisc.hcurldiv(2)
    assert oj == ot
    sj = dj(jm, "wall|inlet|cyl", "outlet")
    st_ = dt(tm, "wall|inlet|cyl", "outlet")
    assert [s.ndof for s in sj] == [s.ndof for s in st_]
    assert sorted(tdisc.__all__) == sorted(
        n for n in dir(jdisc) if not n.startswith("_") and n not in
        ("H1", "H1_with_bubble", "L2", "Nonconforming", "VectorSpace",
         "annotations"))


# -- the mixed systems -------------------------------------------------------


@pytest.mark.parametrize("name", list(MIXED))
def test_mixed_system_matches_jax(systems, name):
    js, ts = systems(name)
    assert js.ndofs == ts.ndofs
    assert _rel(js.f, ts.f) <= 1e-13
    assert np.abs(np.asarray(js.g) - ts.g.numpy()).max() <= 1e-13
    assert np.abs(np.asarray(js.u_bc) - ts.u_bc.numpy()).max() <= 1e-13
    rng = np.random.default_rng(11)
    u = rng.standard_normal(js.f.shape[0])
    p = rng.standard_normal(js.g.shape[0])
    for fj, ft, x in ((js.A, ts.A, u), (js.B, ts.B, u), (js.BT, ts.BT, p),
                      (js.preA, ts.preA, u), (js.preM, ts.preM, p)):
        assert _rel(*_apply_both(fj, ft, x)) <= 1e-12


@pytest.mark.parametrize("name", ["TH2", "P2+-P1"])
def test_twolevel_preconditioner_matches_jax(systems, name):
    js, ts = systems(name, "twolevel")
    u = np.random.default_rng(12).standard_normal(js.f.shape[0])
    assert _rel(*_apply_both(js.preA, ts.preA, u)) <= 1e-12
    assert _rel(*_apply_both(js.A, ts.A, u)) <= 1e-12
    assert ts.tables["patch_inverses"] is not None


def _histories_match(ej, et, head=HEAD):
    """Equal lengths, and the first ``head`` entries within 1e-8 of each
    other (relative).  Past them the two packages' histories part: the
    sums' roundoff grows about tenfold per iteration once the Lanczos
    vectors lose orthogonality (on these systems the entries first differ
    by 1e-12 between iterations 37 and 73, by 1e-2 some ten iterations
    later), while the counts and the solutions still agree."""
    ej, et = np.asarray(ej, np.float64), np.asarray(et, np.float64)
    assert len(ej) == len(et), (len(ej), len(et))
    n = min(head, len(ej))
    assert np.all(np.abs(et[:n] - ej[:n]) <= 1e-8 * np.abs(ej[:n]))


def _jax_k(js):
    return float(jax_bp_scale(js.A, js.preA, js.f)[0])


@pytest.mark.parametrize("name,a_pre,optimized",
                         [("TH2", "twolevel", False),
                          ("TH2", "twolevel", True),
                          ("P1nc-P0", "twolevel", False),
                          ("P2+-P1", "twolevel", False),
                          ("mini", "jacobi", False),
                          ("mini", "twolevel", True)])
def test_bpcg_matches_jax(systems, name, a_pre, optimized):
    """Both packages' solve_with_bramble_pasciak_cg, the port with the JAX
    package's k: equal counts, histories, solutions; the inlet velocity
    equals its boundary values."""
    js, ts = systems(name, a_pre)
    k = _jax_k(js)
    uj, pj, ej, _, nj = jst.solve_with_bramble_pasciak_cg(
        js, TOL, 10000, optimized=optimized)
    got = {}
    ut, pt, et, time_t, nt = tst.solve_with_bramble_pasciak_cg(
        ts, TOL, 10000, optimized=optimized, scale_k=k, result=got)
    assert nj == nt and got["scale_k"] == k and time_t > 0
    assert got["result"].converged
    _histories_match(ej, et)
    assert _rel(uj, ut.numpy()) <= 1e-8
    assert _rel(pj, pt.numpy()) <= 1e-8
    inlet = ts.V.boundary_dof_mask("inlet")
    np.testing.assert_array_equal(ut.numpy()[inlet], ts.u_bc.numpy()[inlet])


def test_min_res_matches_jax(systems):
    js, ts = systems("TH2", "twolevel")
    uj, pj, ej, _, _ = jst.solve_with_min_res(js, TOL, 10000)
    got = {}
    ut, pt, et, _, _ = tst.solve_with_min_res(ts, TOL, 10000, result=got)
    assert got["result"].converged
    _histories_match(ej, et)
    assert _rel(uj, ut.numpy()) <= 1e-8
    assert _rel(pj, pt.numpy()) <= 1e-8


def test_solve_driver_defaults_to_the_inlet_profile(meshes):
    """``solve`` supplies the reference's inflow when none is given."""
    _, tm = meshes
    seen = {}

    def solver(system):
        seen["system"] = system
        return system.u_bc, system.g, [1.0], 0.0, system.ndofs

    tst.solve(tm, tdisc.taylor_hood(2)[0], solver, device="cpu")
    assert float(seen["system"].u_bc.abs().max()) > 1.0


# -- the sweep harness -------------------------------------------------------


def _read_csv(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def test_run_harness_csv_matches_jax(tmp_path, systems):
    """Both packages' ``run`` over two families (TH2 and mini, two-level
    A-preconditioner): the same CSV but the solve times; the port returns
    its rows."""
    ks = {"taylor hood 2": _jax_k(systems("TH2", "twolevel")[0]),
          "mini": _jax_k(systems("mini", "twolevel")[0])}

    def methods(pkg, st_mod, **kw):
        def solve(m, d, s):
            return st_mod.solve(m, d, s, a_pre="twolevel", **kw)

        return {"mixed": {"solve": solve, "discretizations": {
                    "taylor hood 2": pkg.taylor_hood(2)}},
                "enriched": {"solve": solve, "discretizations": {
                    "mini": pkg.mini()}}}

    jax_solvers = {"bramble pasciak cg": lambda s: (
        jst.solve_with_bramble_pasciak_cg(s, tolerance=TOL))}

    def port_bpcg(system):
        k = ks["mini" if system.V.scalar.basis.n_cell else "taylor hood 2"]
        return tst.solve_with_bramble_pasciak_cg(system, tolerance=TOL,
                                                 scale_k=k)

    fj, ft = tmp_path / "jax.csv", tmp_path / "port.csv"
    jst.run([MAXH], methods(jdisc, jst), jax_solvers, str(fj))
    rows = tst.run([MAXH], methods(tdisc, tst, device="cpu"),
                   {"bramble pasciak cg": port_bpcg}, str(ft))
    a, b = _read_csv(fj), _read_csv(ft)
    assert a[0] == b[0] == [""] + list(tst.CSV_COLUMNS)
    assert len(a) == len(b) == len(rows) + 1
    cols = a[0]
    it, err = cols.index("iteration"), cols.index("error")
    for ra, rb in zip(a[1:], b[1:]):
        for c, x, y in zip(cols, ra, rb):
            if c == "solver_time":
                assert float(y) > 0
            elif c != "error":
                assert x == y, (c, x, y)
        # the error histories as _histories_match compares them
        if int(ra[it]) < HEAD:
            assert abs(float(ra[err]) - float(rb[err])) <= 1e-8 * abs(
                float(ra[err]))
    assert rows[0]["method"] == "mixed" and rows[-1]["method"] == "enriched"


def test_run_stokes_script_matches_jax():
    """The port's run_stokes script sweeps the JAX script's configuration:
    the same mesh sizes, families, active entries and solvers."""
    spec = importlib.util.spec_from_file_location(
        "jax_run_stokes", os.path.join(ROOT, "scripts", "run_stokes.py"))
    js = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(js)
    from navier_stokes_tpu_torch.scripts import run_stokes as ts

    assert ts.mesh_sizes == js.mesh_sizes
    tm = ts.methods("cpu")
    assert list(tm) == list(js.methods)
    for fam in tm:
        dj, dt = js.methods[fam]["discretizations"], tm[fam][
            "discretizations"]
        assert list(dj) == list(dt)
        assert [v[1] for v in dj.values()] == [v[1] for v in dt.values()]
    assert list(ts.solver_factories) == list(js.solver_factories)


def test_maybe_profile_writes_a_trace(tmp_path):
    with maybe_profile(False, str(tmp_path / "off")):
        torch.ones(3).sum()
    assert not (tmp_path / "off").exists()
    with maybe_profile(True, str(tmp_path / "on")):
        torch.ones(3).sum()
    (trace,) = list((tmp_path / "on").iterdir())
    assert trace.suffix == ".json" and trace.stat().st_size > 0

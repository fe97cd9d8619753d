"""Parity of the port's BPCG initial solve (``NavierStokesMCS.SolveInitial``)
and the rest of the 3D model's API with the JAX package.

Fixtures, each port model built from the JAX model's host tables
(``load_host_tables``) on the CPU, one torch thread:

* ``plates``: the 24-tet Poiseuille-between-plates mesh of
  tests/test_navier_stokes_mcs3d.py, one model per A-preconditioner
  (``faceblock``, ``auxspace``) in each package, and its enclosed twin
  (``outflow=""``);
* the shortened channel of tests/test_navier_stokes_mcs3d.py:_channel3d
  (``channel_with_cylinder_mesh_3d(0.35, length=1.2,
  circle_resolution=8)``, 936 tets), straight, the port's
  ``flagship.build_model`` on the JAX auxspace model's tables.

Tolerances and what is held equal:

* BPCG v1 and v2 on a seeded numpy saddle system, with the JAX package's
  Bramble-Pasciak scaling carried across: equal iteration counts, error
  histories (NaN where JAX has NaN) and x within 1e-10;
  ``bp_scale_factor`` with the JAX start vector (``jax.random.PRNGKey(0)``)
  passed as ``v0``: k and the condition estimate within 1e-8 relative;
* each of the four ``_preA_for`` variants (faceblock / auxspace, additive /
  GS) on a seeded vector: 1e-12 relative;
* ``SolveInitial`` on the plates at tol 1e-10 with the JAX scaling (the
  port's Lanczos on the JAX start vector): the JAX
  model's iteration counts (425 / 223 / 155 / 63), u within 1e-8 of the JAX
  model's, the Poiseuille velocity error < 1e-7 as in
  ``test_mcs_ns_3d_poiseuille_exact``; the skeleton preconditioner's
  symmetrized tables (the port's flagship departure) give the same counts;
* auxspace GS on the channel at tol 1e-8, its scaling from the port's
  Lanczos on the JAX start vector: the count of the JAX model's own
  ``SolveInitial(GS=True, tol=1e-8)``, run here on the same mesh and
  tables, u within 1e-8 of the JAX model's, and a true relative residual
  of the saddle system below 1e-7;
* ``AddForce`` / ``volumeforce``: f within 1e-13 relative;
  ``reconstruct_stress`` on the same u: 1e-12 relative; the direct-solve
  Poiseuille stress exact to 1e-8 as in ``test_mcs_ns_3d_poiseuille_direct``;
* enclosed flow: B, B_raw, BT, preM and the projection preconditioner
  within 1e-12 relative; ``Project`` with the JAX package's
  CG count (within 1) and ||B u|| < 1e-5 ||B v||.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from navier_stokes_tpu.fem.quadrature import tetrahedron_rule
from navier_stokes_tpu.linalg.lanczos import (
    lanczos_eigenvalues as jax_lanczos,
)
from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.mesh.generators import extrude_to_tets, rectangle_mesh
from navier_stokes_tpu.models.navier_stokes_mcs import (
    NavierStokesMCS as JaxNavierStokesMCS,
)
from navier_stokes_tpu.models.stokes_hybrid3d import (
    build_faceblock_preconditioner_3d as jax_faceblock_preconditioner,
)
from navier_stokes_tpu.models.stokes_hybrid3d import (
    hybrid_blocks_3d as jax_hybrid_blocks_3d,
)
from navier_stokes_tpu.ops.assembly import assemble_csr, assemble_csr_rect
from navier_stokes_tpu.precond.chebyshev import (
    chebyshev_preconditioner as jax_chebyshev,
)
from navier_stokes_tpu.solvers.bpcg import (
    bp_scale_factor as jax_bp_scale_factor,
)
from navier_stokes_tpu.solvers.bpcg import bramble_pasciak_cg as jax_bpcg
from navier_stokes_tpu.solvers.bpcg import (
    bramble_pasciak_cg_opt as jax_bpcg_opt,
)
from navier_stokes_tpu.solvers.cg import cg as jax_cg
from navier_stokes_tpu_torch.flagship import build_model, uin
from navier_stokes_tpu_torch.linalg.pytree import (
    tadd,
    taxpy,
    tdot,
    tscale,
    tsub,
    tzeros_like,
)
from navier_stokes_tpu_torch.mesh.mesh import Mesh
from navier_stokes_tpu_torch.models import NavierStokesMCS, load_host_tables
from navier_stokes_tpu_torch.models.auxspace3d import (
    build_skeleton_preconditioner_3d,
)
from navier_stokes_tpu_torch.models.stokes_hybrid3d import (
    build_faceblock_preconditioner_3d,
    hybrid_blocks_3d,
)
from navier_stokes_tpu_torch.ops import block_mv as bm
from navier_stokes_tpu_torch.solvers.bpcg import (
    bp_scale_factor,
    bramble_pasciak_cg,
    bramble_pasciak_cg_opt,
)

PLATES_KW = dict(nu=1.0, inflow="diri", outflow="outlet", wall="",
                 timestep=1e-3, order=2)
# JAX model's SolveInitial(iterative=True, GS=..., tol=1e-10) on the plates
# (the test runs it; listed for the reader)
PLATES_JAX_COUNTS = {("faceblock", False): 425, ("faceblock", True): 223,
                     ("auxspace", False): 155, ("auxspace", True): 63}
# the shortened channel of tests/test_navier_stokes_mcs3d.py:_channel3d
CHANNEL_MAXH = 0.35
VARIANTS = [("faceblock", False), ("faceblock", True), ("auxspace", False),
            ("auxspace", True)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    PyTorch's thread pool beside them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _flat(cache):
    return {f"{key}_{i}": a for key, tup in cache.items()
            for i, a in enumerate(tup)}


def _jax_v0(n):
    """The start vector of the JAX package's Lanczos (lanczos.py:53-58)."""
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float64)))


def _plates_uin(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = p[:, 1] * (1.0 - p[:, 1])
    return out


def _force(p):
    return np.stack([np.sin(3 * p[:, 0]), np.cos(2 * p[:, 1]) * p[:, 2],
                     p[:, 0] * p[:, 1] - 0.5], axis=1)


def _velocity_error(ns, u):
    """tests/test_navier_stokes_mcs3d.py's Poiseuille velocity error."""
    mesh = ns.mesh
    hd = ns.V
    q3 = tetrahedron_rule(6)
    vals_ref, _ = hd.tabulate_elements(q3.points)
    J, detJ, _ = mesh.element_jacobians
    val_p = np.einsum("ecA,eqiA->eqic", J, vals_ref) / detJ[:, None, None,
                                                            None]
    uq = np.einsum("eqic,ei->eqc", val_p,
                   u[ns.Xv.element_dofs[:, : hd.n_basis]])
    qpts = mesh.points[mesh.elements[:, 0]][:, None, :] + np.einsum(
        "eab,qb->eqa", J, q3.points)
    ex = qpts[..., 1] * (1.0 - qpts[..., 1])
    return max(np.abs(uq[..., 0] - ex).max(), np.abs(uq[..., 1:]).max())


def _jax_cheb_bounds(mj):
    """The (alpha, beta) of ``mj._mass_chebyshev()``, installed in mj."""
    lams = jax_lanczos(mj._Mv, mj._preMv, mj.u_bc, 30)
    beta = 1.05 * float(jnp.max(lams))
    alpha = 0.02 * beta
    mj._mass_cheb = jax_chebyshev(mj._Mv, mj._preMv, mj.u_bc, degree=16,
                                  bounds=(alpha, beta))
    return alpha, beta


def _port_mesh(jmesh):
    """The port's copy of a JAX package mesh."""
    return Mesh(jmesh.points.copy(), jmesh.elements.copy(),
                {k: np.asarray(v).copy()
                 for k, v in jmesh.boundary_tags.items()})


@pytest.fixture(scope="module")
def plates(one_torch_thread):
    base = rectangle_mesh(0.5, 1.0, 1.0)
    jmesh = extrude_to_tets(base, np.linspace(0, 0.5, 2))
    jmesh.tag_boundary_by_predicate(
        "outlet", lambda p: np.abs(p[:, :, 0] - 1.0) < 1e-9)
    rest = np.setdiff1d(jmesh.boundary_facets, jmesh.boundary_tags["outlet"])
    jmesh.boundary_tags["diri"] = rest.astype(np.int32)
    pmesh = _port_mesh(jmesh)
    cache = {}
    mj, mp = {}, {}
    for pre in ("faceblock", "auxspace"):
        mj[pre] = JaxNavierStokesMCS(jmesh, uin=_plates_uin,
                                     preconditioner=pre, assembly_cache=cache,
                                     **PLATES_KW)
    tables = _flat(cache)
    for pre in ("faceblock", "auxspace"):
        mp[pre] = NavierStokesMCS(pmesh, uin=_plates_uin, preconditioner=pre,
                                  device="cpu",
                                  assembly_cache=load_host_tables(tables),
                                  **PLATES_KW)
    return dict(mj=mj, mp=mp, jmesh=jmesh, pmesh=pmesh, tables=tables,
                cache=cache)


def _jax_scale_k(mj, GS):
    f_mod = jnp.where(mj.free, mj.f - mj.A_raw(mj.u_bc), 0.0)
    return float(jax_bp_scale_factor(mj.A, mj._preA_for(GS), f_mod)[0])


def _scale_k(mp, GS):
    """The JAX model's Bramble-Pasciak scaling, from the port's Lanczos on
    the JAX start vector (held to the JAX k by
    :func:`test_bp_scale_factor_matches_jax_with_its_start_vector`)."""
    f_mod = torch.where(mp.free, mp.f - mp.A_raw(mp.u_bc), 0.0)
    return bp_scale_factor(mp.A, mp._preA_for(GS), f_mod,
                           v0=_jax_v0(mp.n))[0]


# -- the solvers on a seeded saddle system -------------------------------------


def _saddle(seed=0, n=60, m=12):
    """SPD A (condition 1e2), full-rank B, and SPD preconditioners near the
    inverses of A and of the Schur complement (so that the histories of
    the two packages, which drift apart by f64 roundoff growing with each
    iteration, still agree to 1e-10 at convergence)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.geomspace(1.0, 100.0, n)) @ Q.T
    B = rng.standard_normal((m, n))
    PA = np.linalg.inv(A + 0.3 * np.diag(np.diag(A)))
    PM = np.linalg.inv(B @ np.linalg.solve(A, B.T) + 0.3 * np.eye(m))
    f, g = rng.standard_normal(n), rng.standard_normal(m)
    return A, B, PA, PM, f, g


def _ops(arrays, lib):
    cast = jnp.asarray if lib == "jax" else torch.from_numpy
    A, B, PA, PM = (cast(a) for a in arrays)
    return (lambda u: A @ u, lambda u: B @ u, lambda p: B.T @ p,
            lambda u: PA @ u, lambda p: PM @ p)


@pytest.mark.parametrize("variant", ["v1", "v2", "v2_abs"])
def test_bpcg_matches_jax(variant):
    A, B, PA, PM, f, g = _saddle()
    opj, opt = _ops((A, B, PA, PM), "jax"), _ops((A, B, PA, PM), "torch")
    fj, gj = jnp.asarray(f), jnp.asarray(g)
    ft, gt = torch.from_numpy(f), torch.from_numpy(g)
    k = float(jax_bp_scale_factor(opj[0], opj[3], fj)[0])
    if variant == "v1":
        rj = jax_bpcg(*opj, fj, gj, tol=1e-12, max_steps=300, scale_k=k)
        rp = bramble_pasciak_cg(*opt, ft, gt, tol=1e-12, max_steps=300,
                                scale_k=k)
    else:
        kw = dict(tol=1e-10, rel_err=True) if variant == "v2" else dict(
            tol=1e-8, rel_err=False)
        rj = jax_bpcg_opt(*opj, fj, gj, maxsteps=300, scale_k=k, **kw)
        rp = bramble_pasciak_cg_opt(*opt, ft, gt, maxsteps=300, scale_k=k,
                                    **kw)
    assert bool(rj.converged) and rp.converged
    assert rp.iterations == int(rj.iterations) > 30
    ej, ep = np.asarray(rj.errors), rp.errors
    np.testing.assert_array_equal(np.isnan(ej), np.isnan(ep))
    np.testing.assert_allclose(ep[~np.isnan(ep)], ej[~np.isnan(ej)],
                               rtol=0, atol=1e-10)
    for xj, xp in zip(rj.x, rp.x):
        assert _rel(np.asarray(xj), xp.numpy()) <= 1e-10
    assert rp.err0 == pytest.approx(float(rj.err0), rel=1e-12)


def test_bpcg_opt_stops_at_maxsteps_as_jax():
    """Past ``maxsteps`` both report ``it - 1`` and not converged."""
    A, B, PA, PM, f, g = _saddle(1)
    opj, opt = _ops((A, B, PA, PM), "jax"), _ops((A, B, PA, PM), "torch")
    k = float(jax_bp_scale_factor(opj[0], opj[3], jnp.asarray(f))[0])
    rj = jax_bpcg_opt(*opj, jnp.asarray(f), jnp.asarray(g), tol=1e-14,
                      maxsteps=7, scale_k=k)
    rp = bramble_pasciak_cg_opt(*opt, torch.from_numpy(f),
                                torch.from_numpy(g), tol=1e-14, maxsteps=7,
                                scale_k=k)
    assert not rp.converged and not bool(rj.converged)
    assert rp.iterations == int(rj.iterations) == 6
    np.testing.assert_allclose(rp.errors[:7], np.asarray(rj.errors)[:7],
                               rtol=1e-10)


def test_bp_scale_factor_matches_jax_with_its_start_vector(plates):
    A, B, PA, PM, f, g = _saddle()
    opj, opt = _ops((A, B, PA, PM), "jax"), _ops((A, B, PA, PM), "torch")
    kj, cj = jax_bp_scale_factor(opj[0], opj[3], jnp.asarray(f))
    kp, cp = bp_scale_factor(opt[0], opt[3], torch.from_numpy(f),
                             v0=_jax_v0(len(f)))
    assert kp == pytest.approx(float(kj), rel=1e-8)
    assert cp == pytest.approx(float(cj), rel=1e-8)
    # on the model: the additive face-block preconditioner of the plates
    mj, mp = plates["mj"]["faceblock"], plates["mp"]["faceblock"]
    assert _scale_k(mp, False) == pytest.approx(_jax_scale_k(mj, False),
                                                rel=1e-8)


def test_tuple_algebra():
    a = (torch.arange(3.0), (torch.ones(2), torch.full((2,), 2.0)))
    b = tscale(2.0, a)
    assert float(tdot(a, b)) == 2 * (5.0 + 2.0 + 8.0)
    c = taxpy(-1.0, b, tadd(a, a))
    assert float(tdot(c, c)) == 0.0
    assert float(tdot(tsub(b, a), a)) == float(tdot(a, a))
    z = tzeros_like(a)
    assert float(tdot(z, z)) == 0.0 and z[1][0].shape == (2,)
    assert torch.equal(taxpy(2.0, torch.ones(3), torch.ones(3)),
                       torch.full((3,), 3.0))


# -- the A-preconditioners -------------------------------------------------------


@pytest.mark.parametrize("pre,GS", VARIANTS)
def test_preA_variants_match_jax(plates, pre, GS):
    mj, mp = plates["mj"][pre], plates["mp"][pre]
    x = np.random.default_rng(3).standard_normal(mp.n)
    want = np.asarray(mj._preA_for(GS)(jnp.asarray(x)))
    got = mp._preA_for(GS)(torch.from_numpy(x))
    assert got.dtype == torch.float64
    assert _rel(want, got.numpy()) <= 1e-12
    assert mp._preA_for(GS) is mp._preA_for(GS)  # built once
    if not GS:
        assert mp.preA is mp._preA_for(False)


@pytest.mark.parametrize("kind", ["face", "vertexstar"])
def test_hybrid_blocks_and_faceblock_preconditioner_match_jax(plates, kind):
    mj, mp = plates["mj"]["faceblock"], plates["mp"]["faceblock"]
    got = hybrid_blocks_3d(mp.Xv, kind)
    want = jax_hybrid_blocks_3d(mj.Xv, kind)
    assert [list(b) for b in got] == [list(b) for b in want]
    pj = jax_faceblock_preconditioner(mj.Xv, mj.A_cond_np, jnp.float64,
                                      blocks=kind)
    pp = build_faceblock_preconditioner_3d(mp.Xv, mp.A_cond_np,
                                           torch.float64, blocks=kind,
                                           device="cpu")
    x = np.random.default_rng(4).standard_normal(mp.n)
    assert _rel(np.asarray(pj(jnp.asarray(x))),
                pp(torch.from_numpy(x)).numpy()) <= 1e-12


def test_f64_tables_take_the_plain_route(monkeypatch):
    """An f64 table apply is the plain batched product on any device,
    chosen by dtype when the table is built: the kernel wrappers are never
    called for it (they refuse f64 tables on the card); f32 tables still go
    through them."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((9, 4, 6))
    x = torch.from_numpy(rng.standard_normal((9, 6)))
    blocks = [torch.from_numpy(rng.standard_normal((c, d, d)))
              for c, d in ((3, 5), (2, 7))]
    calls = []
    real_mv, real_seg = bm.block_mv, bm.block_mv_segments
    monkeypatch.setattr(bm, "block_mv",
                        lambda *a: calls.append("mv") or real_mv(*a))
    monkeypatch.setattr(bm, "block_mv_segments",
                        lambda *a: calls.append("seg") or real_seg(*a))
    y = bm.make_table_apply(A, store_dtype=torch.float64, device="cpu",
                            compute_dtype=torch.float64)(x)
    assert torch.equal(y, torch.einsum("bmk,bk->bm", torch.from_numpy(A), x))
    apply = bm.make_segment_apply(blocks, 6, 7, torch.float64, "cpu",
                                  torch.float64)
    xs = torch.from_numpy(rng.standard_normal((6, 7)))
    want = torch.einsum("bmk,bk->bm", apply.table.padded(), xs)
    assert _rel(want.numpy(), apply(xs).numpy()) <= 1e-15
    assert calls == []
    bm.make_table_apply(A, device="cpu")(x.float())
    bm.make_segment_apply(blocks, 6, 7, device="cpu")(xs.float())
    assert calls == ["mv", "seg"]


# -- SolveInitial ---------------------------------------------------------------


@pytest.mark.parametrize("pre,GS", VARIANTS)
def test_solve_initial_counts_match_jax(plates, pre, GS):
    mj, mp = plates["mj"][pre], plates["mp"][pre]
    u0, p0 = mp.u, mp.p
    try:
        rj = mj.SolveInitial(iterative=True, GS=GS, tol=1e-10,
                             maxsteps=5000)
        k = _scale_k(mp, GS)
        rp = mp.SolveInitial(iterative=True, GS=GS, tol=1e-10,
                             maxsteps=5000, scale_k=k)
        assert rp.converged and bool(rj.converged)
        assert rp.iterations == int(rj.iterations) == PLATES_JAX_COUNTS[
            (pre, GS)]
        assert mp.stokes_bpcg_iterations == rp.iterations
        assert mp.stokes_bpcg_time > 0 and mp.stokes_bpcg_scale_k == k
        assert _rel(np.asarray(mj.u), mp.u.numpy()) <= 1e-8
        assert _velocity_error(mp, mp.u.numpy()) < 1e-7
    finally:
        mp.u, mp.p = u0, p0


@pytest.mark.parametrize("GS", [False, True])
def test_symmetrized_skeleton_tables_keep_the_counts(plates, GS):
    """The port's flagship departure (``symmetrize=True``) on the model's
    f64 skeleton preconditioner moves no count on the plates; the model
    itself builds the JAX package's tables (``symmetrize=False``)."""
    mp = plates["mp"]["auxspace"]
    f64 = torch.float64
    pre = build_skeleton_preconditioner_3d(
        mp.Xv, mp.A_cond_np, mp._dirich, "cpu", f64,
        coarse_coefficient=mp.nu, gs=GS, ext_dtype=f64, inv_dtype=f64,
        panel_dtype=f64, sweep_dtype=f64, coarse_target=0.9, symmetrize=True)
    f_mod = torch.where(mp.free, mp.f - mp.A_raw(mp.u_bc), 0.0)
    res = bramble_pasciak_cg_opt(mp.A, mp.B, mp.BT, pre, mp.preM, f_mod,
                                 -mp.B_raw(mp.u_bc), tol=1e-10, maxsteps=5000,
                                 scale_k=_scale_k(mp, GS))
    assert res.converged
    assert res.iterations == PLATES_JAX_COUNTS[("auxspace", GS)]


def test_solve_initial_timesteps_still_steps(plates):
    """``SolveInitial(timesteps=n)`` keeps the pseudo-time branch and
    returns None."""
    mp = plates["mp"]["faceblock"]
    u0, p0 = mp.u, mp.p
    try:
        assert mp.SolveInitial(timesteps=1) is None
        assert float(torch.linalg.norm(mp.B_raw(mp.u))) <= 1e-7
    finally:
        mp.u, mp.p = u0, p0


def test_channel_auxspace_gs_count_matches_jax(one_torch_thread):
    """The JAX model's own solve and the port's on the same channel and
    tables: the same count, u within 1e-8 relative."""
    jmesh = channel_with_cylinder_mesh_3d(CHANNEL_MAXH, length=1.2,
                                          circle_resolution=8)
    cache = {}
    mj = JaxNavierStokesMCS(
        jmesh, nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=uin, timestep=2e-3, order=2, preconditioner="auxspace",
        assembly_cache=cache)
    mp = build_model(CHANNEL_MAXH, device="cpu", curved=False,
                     mesh=_port_mesh(jmesh),
                     assembly_cache=load_host_tables(_flat(cache)))
    assert mp.preconditioner == "auxspace"
    rj = mj.SolveInitial(iterative=True, GS=True, tol=1e-8, maxsteps=20000)
    f_mod = torch.where(mp.free, mp.f - mp.A_raw(mp.u_bc), 0.0)
    g_mod = -mp.B_raw(mp.u_bc)
    res = mp.SolveInitial(GS=True, tol=1e-8, maxsteps=20000,
                          scale_k=_scale_k(mp, True))
    assert res.converged and bool(rj.converged)
    assert res.iterations == int(rj.iterations) > 50
    assert _rel(np.asarray(mj.u), mp.u.numpy()) <= 1e-8
    du, p = res.x
    r0 = f_mod - mp.A(du) - mp.BT(p)
    r1 = g_mod - mp.B(du)
    rel = float(torch.sqrt(tdot((r0, r1), (r0, r1)))
                / torch.sqrt(tdot((f_mod, g_mod), (f_mod, g_mod))))
    assert rel < 1e-7
    assert bool(torch.isfinite(mp.u).all())


# -- volume force and stress reconstruction ------------------------------------


def test_add_force_matches_jax(plates):
    jmesh, pmesh = plates["jmesh"], plates["pmesh"]
    mj = JaxNavierStokesMCS(jmesh, uin=_plates_uin, preconditioner="faceblock",
                            volumeforce=_force,
                            assembly_cache=dict(plates["cache"]), **PLATES_KW)
    mp = NavierStokesMCS(pmesh, uin=_plates_uin, volumeforce=_force,
                         device="cpu",
                         assembly_cache=load_host_tables(plates["tables"]),
                         **PLATES_KW)
    fj = np.asarray(mj.f)
    assert np.abs(fj).max() > 1e-3
    assert np.abs(mp.f.numpy() - fj).max() <= 1e-13 * np.abs(fj).max()
    mp.AddForce(_force)
    mj.AddForce(_force)
    assert _rel(np.asarray(mj.f), mp.f.numpy()) <= 1e-13


def test_reconstruct_stress_matches_jax(plates):
    mj, mp = plates["mj"]["auxspace"], plates["mp"]["auxspace"]
    u = np.random.default_rng(6).standard_normal(mp.n)
    want = mj.reconstruct_stress(jnp.asarray(u))
    assert _rel(want, mp.reconstruct_stress(torch.from_numpy(u))) <= 1e-12
    assert _rel(want, mp.reconstruct_stress(u)) <= 1e-12


def test_direct_poiseuille_stress_is_exact(plates):
    """tests/test_navier_stokes_mcs3d.py's direct solve on the port's
    tables: the Poiseuille velocity to 1e-9 and, reconstructed,
    sigma = -2 nu eps(u) to 1e-8."""
    ns = plates["mp"]["faceblock"]
    mesh = ns.mesh
    K = assemble_csr(ns.A_cond_np, ns.Xv.element_dofs, ns.n)
    Bg = assemble_csr_rect(ns.B_loc_np, ns.Q.element_dofs,
                           ns.Xv.element_dofs, ns.Q.ndof, ns.n)
    idx = np.where(ns.free.numpy())[0]
    KK = sp.bmat([[K[idx][:, idx], Bg[:, idx].T], [Bg[:, idx], None]]
                 ).tocsc()
    u_bc = ns.u_bc.numpy()
    rhs = np.concatenate([(ns.f.numpy() - K @ u_bc)[idx], -(Bg @ u_bc)])
    sol = spla.spsolve(KK, rhs)
    du = np.zeros(ns.n)
    du[idx] = sol[: len(idx)]
    assert _velocity_error(ns, du + u_bc) < 1e-9

    xi = ns.reconstruct_stress(torch.from_numpy(du + u_bc))
    nbs = ns.sigma_basis.n_basis
    J, detJ, Jinv = mesh.element_jacobians
    q3 = tetrahedron_rule(6)
    svals, _ = ns.sigma_basis.tabulate(q3.points)
    sp_phys = np.einsum("eai,qnab,ejb->eqnij", Jinv, svals, J
                        ) / detJ[:, None, None, None, None]
    sig_q = np.einsum("eqnij,en->eqij", sp_phys, xi[:, :nbs])
    qpts = mesh.points[mesh.elements[:, 0]][:, None, :] + np.einsum(
        "eab,qb->eqa", J, q3.points)
    sig_ex = np.zeros_like(sig_q)
    sig_ex[..., 0, 1] = -(1 - 2 * qpts[..., 1])
    sig_ex[..., 1, 0] = -(1 - 2 * qpts[..., 1])
    assert np.abs(sig_q - sig_ex).max() < 1e-8


# -- enclosed flow ----------------------------------------------------------------


@pytest.fixture(scope="module")
def enclosed(plates):
    """The plates closed at the outlet (``outflow=""``, the outlet a wall),
    the JAX model's Chebyshev bounds carried into the port's."""
    kw = dict(PLATES_KW, outflow="", wall="outlet")
    mj = JaxNavierStokesMCS(plates["jmesh"], uin=_plates_uin,
                            preconditioner="faceblock",
                            assembly_cache=dict(plates["cache"]), **kw)
    bounds = _jax_cheb_bounds(mj)
    mp = NavierStokesMCS(
        plates["pmesh"], uin=_plates_uin, preconditioner="faceblock",
        device="cpu",
        assembly_cache=load_host_tables({**plates["tables"],
                                         "cheb_bounds": np.asarray(bounds)}),
        **kw)
    return mj, mp


@pytest.mark.parametrize("op", ["B", "B_raw", "BT", "preM",
                                "_pre_proj_twolevel"])
def test_enclosed_operators_match_jax(enclosed, op):
    mj, mp = enclosed
    rng = np.random.default_rng(7)
    x = rng.standard_normal(mp.n if op in ("B", "B_raw") else mp.Q.ndof)
    fj, fp = getattr(mj, op), getattr(mp, op)
    if op == "_pre_proj_twolevel":
        fj, fp = fj(), fp()
    want = np.asarray(fj(jnp.asarray(x)))
    got = fp(torch.from_numpy(x)).numpy()
    assert _rel(want, got) <= 1e-12
    if op != "BT":
        assert abs(got.mean()) <= 1e-12 * np.abs(got).max()  # demeaned


def test_enclosed_project_matches_jax(enclosed):
    mj, mp = enclosed
    mask = np.asarray(mj.free & mj._umask)
    v = np.where(mask, np.random.default_rng(0).standard_normal(mp.n), 0.0)
    Minv = mj._mass_chebyshev()
    rj = jax_cg(lambda p: mj.B(Minv(mj.BT(p))), mj.B_raw(jnp.asarray(v)),
                pre=mj._pre_proj_twolevel(), tol=1e-9, maxsteps=2000)
    vt = torch.from_numpy(v)
    u_new = mp.Project(vt)
    assert float(torch.linalg.norm(mp.B_raw(u_new))) < 1e-5 * float(
        torch.linalg.norm(mp.B_raw(vt)))
    assert abs(mp.last_iterations["project"] - int(rj.iterations)) <= 1
    want = np.asarray(mj.Project(jnp.asarray(v)))
    assert _rel(want, u_new.numpy()) <= 1e-8

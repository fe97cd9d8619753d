"""Parity of the port's HDG Stokes family (navier_stokes_tpu_torch
``models.stokes_hybrid``: ``assemble_hdg_stokes``,
``assemble_hdg_stokes_curved``, ``build_hybrid_stokes_system``,
``solve_hybrid``) with the JAX package.

Both packages build the reference's active configuration, "HDG BDM 2"
(alpha 10), and the "HDG RT 1" and hodivfree variants on the channel with
cylinder at maxh 0.3 (420 triangles), straight and on the order-3 curved
cylinder, from the same inputs; the port on the CPU, where its wrappers
take the kernels' plain versions.  Tolerances:

* host tables (A_loc, B_loc, the volume-force vectors, the boundary
  interpolation): 1e-13 (relative to the table's largest entry);
* f, g, u_bc: 1e-13; A, B, B^T, preA and preM applies: 1e-12 (relative,
  2-norm);
* Bramble-Pasciak CG with the JAX package's k: equal counts, the first 30
  entries of the error histories within 1e-8 (tests/test_torch_stokes.py
  ``_histories_match``), solutions within 1e-8.  With the default edgeblock
  preconditioner the solves run to 1e-10: at 1e-7 (about 1,000
  iterations) the two packages' solutions are only as close as the
  iteration's own accuracy (3e-7 apart), and on the curved mesh the
  Bramble-Pasciak error measure can dip under the threshold early in one
  package and not the other (851 against 998 iterations once, the early
  stop's true residual 1.2e-4 against 3.1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mcs2d_solve import (
    _rel,
    one_torch_thread,  # noqa: F401  (the module's thread limits)
)
from test_torch_stokes import _histories_match

from navier_stokes_tpu.mesh.curved import curve_to_circle as jax_curve
from navier_stokes_tpu.mesh.generators import (
    channel_with_cylinder_mesh as jax_channel,
)
from navier_stokes_tpu.models import discretizations as jdisc
from navier_stokes_tpu.models import stokes as jst
from navier_stokes_tpu.models import stokes_hybrid as jsh
from navier_stokes_tpu.solvers.bpcg import bp_scale_factor as jax_bp_scale
from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh
from navier_stokes_tpu_torch.mesh.curved import curve_to_circle
from navier_stokes_tpu_torch.models import discretizations as tdisc
from navier_stokes_tpu_torch.models import stokes as tst
from navier_stokes_tpu_torch.models import stokes_hybrid as tsh

MAXH = 0.3
DISCS = {"BDM2": ("bdm_hybrid", (2, 10)), "RT1": ("rt_hybrid", (1, 10)),
         "BDM2-hodivfree": ("bdm_hybrid", (2, 10, True))}


@pytest.fixture(scope="module")
def meshes():
    jm, tm = jax_channel(MAXH), channel_with_cylinder_mesh(MAXH)
    return {False: (jm, None, tm, None),
            True: (jm, jax_curve(jm, "cyl", (0.2, 0.2), 0.05, 3),
                   tm, curve_to_circle(tm, "cyl", (0.2, 0.2), 0.05, 3))}


@pytest.fixture(scope="module")
def systems(meshes):
    cache = {}

    def get(disc, curved, a_pre="edgeblock"):
        key = disc, curved, a_pre
        if key not in cache:
            jm, gj, tm, gt = meshes[curved]
            fname, args = DISCS[disc]
            js = jsh.build_hybrid_stokes_system(
                jm, getattr(jdisc, fname)(*args)[0],
                uin=jst.default_inlet_profile(), a_pre=a_pre, geometry=gj)
            ts = tsh.build_hybrid_stokes_system(
                tm, getattr(tdisc, fname)(*args)[0],
                uin=tst.default_inlet_profile(), a_pre=a_pre, geometry=gt,
                device="cpu")
            cache[key] = js, ts
        return cache[key]

    return get


def _close(a, b, tol=1e-13):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1.0)


@pytest.mark.parametrize("curved", [False, True])
@pytest.mark.parametrize("disc", list(DISCS))
def test_hdg_tables_match_jax(meshes, disc, curved):
    jm, gj, tm, gt = meshes[curved]
    fname, args = DISCS[disc]
    Vj, Qj = getattr(jdisc, fname)(*args)[0](jm, "wall|inlet|cyl")
    Vt, Qt = getattr(tdisc, fname)(*args)[0](tm, "wall|inlet|cyl")
    np.testing.assert_array_equal(Vj.element_dofs, Vt.element_dofs)
    np.testing.assert_array_equal(Vj.element_signs, Vt.element_signs)
    if curved:
        tj = jsh.assemble_hdg_stokes_curved(Vj, Qj, gj, alpha=10.0)
        tt = tsh.assemble_hdg_stokes_curved(Vt, Qt, gt, alpha=10.0)
    else:
        tj = jsh.assemble_hdg_stokes(Vj, Qj, alpha=10.0)
        tt = tsh.assemble_hdg_stokes(Vt, Qt, alpha=10.0)
    _close(tj[0], tt[0])
    _close(tj[1], tt[1])
    _close(tj[2](jst.default_volume_force), tt[2](tst.default_volume_force))
    f = jst.default_inlet_profile()
    _close(jsh.interpolate_hybrid_boundary(Vj, f, "inlet"),
           tsh.interpolate_hybrid_boundary(Vt, f, "inlet"))


@pytest.mark.parametrize("case", [
    ("BDM2", False, "edgeblock"), ("BDM2", True, "edgeblock"),
    ("BDM2", True, "jacobi"), ("BDM2", False, "vertexstar"),
    ("BDM2", True, "auxspace"), ("RT1", True, "edgeblock"),
    ("BDM2-hodivfree", False, "edgeblock")])
def test_hdg_system_matches_jax(systems, case):
    js, ts = systems(*case)
    assert js.ndofs == ts.ndofs
    for a, b in ((js.f, ts.f), (js.g, ts.g), (js.u_bc, ts.u_bc)):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-13 * max(
            np.abs(np.asarray(a)).max(), 1.0)
    rng = np.random.default_rng(21)
    u = rng.standard_normal(js.f.shape[0])
    p = rng.standard_normal(js.g.shape[0])
    for fj, ft, x in ((js.A, ts.A, u), (js.B, ts.B, u), (js.BT, ts.BT, p),
                      (js.preA, ts.preA, u), (js.preM, ts.preM, p)):
        got = ft(torch.from_numpy(x)).numpy()
        assert _rel(np.asarray(fj(jnp.asarray(x))), got) <= 1e-12
    assert tuple(ts.tables["A_loc"].shape[1:]) == (
        ts.V.element_dofs.shape[1],) * 2


@pytest.mark.parametrize("case,tol", [
    (("BDM2", False, "edgeblock"), 1e-10),
    (("BDM2", True, "edgeblock"), 1e-10),
    (("BDM2", False, "auxspace"), 1e-7),
    (("BDM2", True, "auxspace"), 1e-7)])
def test_hdg_bpcg_matches_jax(systems, case, tol):
    js, ts = systems(*case)
    k = float(jax_bp_scale(js.A, js.preA, js.f)[0])
    uj, pj, ej, _, _ = jst.solve_with_bramble_pasciak_cg(js, tol, 10000)
    ut, pt, et, _, _ = tst.solve_with_bramble_pasciak_cg(ts, tol, 10000,
                                                         scale_k=k)
    _histories_match(ej, et)
    assert _rel(uj, ut.numpy()) <= 1e-8
    assert _rel(pj, pt.numpy()) <= 1e-8
    inlet = np.concatenate([ts.V.hdiv.boundary_dof_mask("inlet"),
                            ts.V.facet.boundary_dof_mask("inlet")])
    np.testing.assert_array_equal(ut.numpy()[inlet], ts.u_bc.numpy()[inlet])


def test_solve_hybrid_matches_jax(meshes, systems):
    """``solve_hybrid`` as run_stokes.py calls it (default inflow,
    optimized BPCG through the solver callable) on the curved mesh with
    the auxspace preconditioner."""
    jm, gj, tm, gt = meshes[True]
    js, _ = systems("BDM2", True, "auxspace")
    k = float(jax_bp_scale(js.A, js.preA, js.f)[0])
    uj, _, ej, _, nj = jsh.solve_hybrid(
        jm, jdisc.bdm_hybrid(2, 10)[0],
        lambda s: jst.solve_with_bramble_pasciak_cg(s, optimized=True),
        a_pre="auxspace", geometry=gj)
    ut, _, et, _, nt = tsh.solve_hybrid(
        tm, tdisc.bdm_hybrid(2, 10)[0],
        lambda s: tst.solve_with_bramble_pasciak_cg(s, optimized=True,
                                                    scale_k=k),
        a_pre="auxspace", geometry=gt, device="cpu")
    assert nj == nt
    _histories_match(ej, et)
    assert _rel(uj, ut.numpy()) <= 1e-8

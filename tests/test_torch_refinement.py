"""Parity of the port's mixed-precision refinement drivers
(``navier_stokes_tpu_torch.solvers.refinement``) with the JAX package's, on
the CPU, one torch thread.

* ``mixed_precision_saddle_solve`` on the dense saddle of
  tests/test_refinement.py:14 with the JAX scaling k passed to both: equal
  passes, inner totals within +-1 per pass, x within 1e-9 of the JAX x and
  of the direct solve; ``_scaled`` on the same system, Jacobi-equilibrated,
  likewise but inner totals within 10% (its f32 counts move by a few
  iterations with the summation order of the f32 products);
* ``mixed_precision_minres_refinement`` (the JAX default ``abs_test``)
  and ``_2phase`` on the straight 3D MCS channel at maxh 0.6 (108,960 dofs)
  with each package's ``equilibrated_f32_ops`` (additive skeleton
  preconditioner, bench.py's table storage): r <= tol for both packages,
  the same passes, inner totals within 5% (the port's skeleton tables are
  symmetrized, ROADMAP Queue 3).  The tolerance is loose (1e-2, passes of
  at most 100 iterations): on the CPU the additive preconditioner needs
  about 480 MINRES iterations per pass at this size (1,445 to 1.3e-6 in 3
  passes, 48 s in the JAX package alone); the card runs the 2-phase driver
  to 1e-8 (chip_smoke.py ``[refine]``);
* the three MINRES drivers at deep tolerance on the dense saddle,
  equilibrated as ``equilibrated_f32_ops`` does (the 2-phase driver with
  phase 1 cut to one pass, so that phase 2 carries the solve): r <= tol
  for both, the same passes, inner totals within 10% (f32 sums in another
  order), x within 20 tol of the JAX x and of the direct solve;
* the monotonicity guard: a diverging inner solve is rejected and x stays
  finite;
* ``solve_initial_refined`` on the HDG3D box pair of tests/test_ns_hdg3d.py
  (24 tets, n = 1,296), the port's models on the JAX package's host tables
  and the f32 twin's JAX k passed to the port: r <= 1e-8 for both, the same
  passes, inner totals within 5% (the JAX driver: r = 3.07e-9 in 3 passes,
  241 inner), u within 1e-6 of the JAX u.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.fem.quadrature import tetrahedron_rule
from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.mesh.generators import extrude_to_tets, rectangle_mesh
from navier_stokes_tpu.models.navier_stokes_hdg3d import (
    NavierStokesHDG3D as JaxHDG3D,
)
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
from navier_stokes_tpu.models.stokes_hybrid3d import (
    assemble_hdg_stokes_3d as jax_assemble,
)
from navier_stokes_tpu.solvers import refinement as jref
from navier_stokes_tpu.solvers.bpcg import bp_scale_factor as jax_bp_scale
from navier_stokes_tpu_torch.flagship import build_model, uin
from navier_stokes_tpu_torch.mesh.mesh import Mesh
from navier_stokes_tpu_torch.models import NavierStokesHDG3D, load_host_tables
from navier_stokes_tpu_torch.solvers import refinement as ref

MAXH = 0.6


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    PyTorch's thread pool beside them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense_saddle():
    rng = np.random.default_rng(2)
    n, m = 50, 20
    Q = rng.standard_normal((n, n))
    Ad = Q @ Q.T + n * np.eye(n)
    Bd = rng.standard_normal((m, n))
    f, g = rng.standard_normal(n), rng.standard_normal(m)
    sol = np.linalg.solve(np.block([[Ad, Bd.T], [Bd, np.zeros((m, m))]]),
                          np.concatenate([f, g]))
    Md = Bd @ np.linalg.inv(Ad) @ Bd.T
    return Ad, Bd, Md, f, g, sol


def _jax_ops(Ad, Bd, Md, dt):
    A, B = jnp.asarray(Ad, dt), jnp.asarray(Bd, dt)
    dA, dM = jnp.asarray(np.diag(Ad), dt), jnp.asarray(np.diag(Md), dt)
    return dict(A=lambda x: A @ x, B=lambda x: B @ x, BT=lambda x: B.T @ x,
                preA=lambda x: x / dA, preM=lambda x: x / dM)


def _torch_ops(Ad, Bd, Md, dt):
    A, B = torch.tensor(Ad, dtype=dt), torch.tensor(Bd, dtype=dt)
    dA = torch.tensor(np.diag(Ad), dtype=dt)
    dM = torch.tensor(np.diag(Md), dtype=dt)
    return dict(A=lambda x: A @ x, B=lambda x: B @ x, BT=lambda x: B.T @ x,
                preA=lambda x: x / dA, preM=lambda x: x / dM)


@pytest.mark.parametrize("scaled", [False, True])
def test_saddle_solve_matches_jax_on_dense_saddle(one_torch_thread, scaled):
    Ad, Bd, Md, f, g, sol = _dense_saddle()
    n = len(f)
    if scaled:  # the equilibrated inner system D A D, as refinement.py's
        Dv = 1.0 / np.sqrt(np.diag(Ad))
        As, Bs = Dv[:, None] * Ad * Dv[None, :], Bd * Dv[None, :]
        Ms = Bs @ np.linalg.inv(As) @ Bs.T
        o32j, o32p = (_jax_ops(As, Bs, Ms, jnp.float32),
                      _torch_ops(As, Bs, Ms, torch.float32))
        f32 = jnp.asarray(Dv * f, jnp.float32)
    else:
        o32j, o32p = (_jax_ops(Ad, Bd, Md, jnp.float32),
                      _torch_ops(Ad, Bd, Md, torch.float32))
        f32 = jnp.asarray(f, jnp.float32)
    k, _ = jax_bp_scale(o32j["A"], o32j["preA"], f32)
    o64j = _jax_ops(Ad, Bd, Md, jnp.float64)
    o64p = _torch_ops(Ad, Bd, Md, torch.float64)
    if scaled:
        xj, rj, sj, ij = jref.mixed_precision_saddle_solve_scaled(
            o64j, o32j, jnp.asarray(Dv), jnp.asarray(f), jnp.asarray(g),
            tol=1e-10, scale_k=k)
        xp, rp, sp, ip = ref.mixed_precision_saddle_solve_scaled(
            o64p, o32p, torch.tensor(Dv), torch.tensor(f), torch.tensor(g),
            tol=1e-10, scale_k=float(k))
    else:
        xj, rj, sj, ij = jref.mixed_precision_saddle_solve(
            o64j, o32j, jnp.asarray(f), jnp.asarray(g), tol=1e-10,
            scale_k=k)
        xp, rp, sp, ip = ref.mixed_precision_saddle_solve(
            o64p, o32p, torch.tensor(f), torch.tensor(g), tol=1e-10,
            scale_k=float(k))
    assert float(rj) < 1e-10 and rp < 1e-10
    assert sp == int(sj) and sp <= 4
    # f32 inner products summed in another order (numpy / XLA against
    # torch) move the equilibrated system's counts by a few iterations
    assert abs(ip - int(ij)) <= (0.1 * int(ij) if scaled else sp)
    got = np.concatenate([xp[0].numpy(), xp[1].numpy()])
    want = np.concatenate([np.asarray(xj[0]), np.asarray(xj[1])])
    assert np.abs(got - want).max() <= 1e-9
    assert np.abs(got - sol).max() <= 1e-9
    assert np.abs(got[:n] - sol[:n]).max() <= 1e-9


def test_refinement_guard_rejects_a_diverging_pass(one_torch_thread):
    """The monotonicity guard: an inner solve that returns garbage (here a
    NaN-producing f32 preconditioner) is rejected after one pass, x stays
    at its finite last value and the residual does not rise."""
    Ad, Bd, Md, f, g, _ = _dense_saddle()
    o32 = _torch_ops(Ad, Bd, Md, torch.float32)
    o32["preA"] = lambda x: x * float("nan")
    x, r, steps, _ = ref.mixed_precision_saddle_solve(
        _torch_ops(Ad, Bd, Md, torch.float64), o32, torch.tensor(f),
        torch.tensor(g), tol=1e-10, scale_k=1.0)
    assert steps == 1 and r == 1.0
    assert bool(torch.isfinite(x[0]).all() and torch.isfinite(x[1]).all())
    assert float(x[0].abs().max()) == 0.0


@pytest.fixture(scope="module")
def channel(one_torch_thread):
    """The straight MCS channel at maxh 0.6 in both packages, the port's
    model on the JAX model's host tables, and each package's equilibrated
    f32 operators with bench.py's storage settings (additive)."""
    cache = {}
    mj = NavierStokesMCS(
        channel_with_cylinder_mesh_3d(MAXH), nu=1e-3, inflow="inlet",
        outflow="outlet", wall="wall|cyl", uin=uin, timestep=2e-3, order=2,
        preconditioner="faceblock", assembly_cache=cache)
    mp = build_model(MAXH, device="cpu", curved=False,
                     assembly_cache=load_host_tables(
                         {f"{key}_{i}": a for key, tup in cache.items()
                          for i, a in enumerate(tup)}))
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("NSTPU_SMOOTHER_BF16", "ext,inv")
        mpatch.setenv("NSTPU_DEVICE_TABLES", "0")
        o32j, Dj, _ = jref.equilibrated_f32_ops(mj, gs=False, split=True,
                                                with_ds=True)
    o32p, Dp, _ = ref.equilibrated_f32_ops(mp, gs=False)
    return dict(
        jax=(dict(A=mj.A, B=mj.B, BT=mj.BT), o32j, Dj,
             jnp.where(mj.free, mj.f - mj.A_raw(mj.u_bc), 0.0),
             -mj.B_raw(mj.u_bc)),
        port=(dict(A=mp.A, B=mp.B, BT=mp.BT), o32p, Dp,
              torch.where(mp.free, mp.f - mp.A_raw(mp.u_bc), 0.0),
              -mp.B_raw(mp.u_bc)))


CHANNEL_KW = dict(tol=1e-2, inner_tol=1e-2, inner_maxsteps=100)


def test_minres_refinement_matches_jax_on_channel(channel):
    """The JAX default abs_test (True), one pass to the loose tolerance."""
    _, rj, sj, ij = jref.mixed_precision_minres_refinement(
        *channel["jax"], **CHANNEL_KW)
    xp, rp, sp, ip = ref.mixed_precision_minres_refinement(
        *channel["port"], **CHANNEL_KW)
    assert float(rj) <= CHANNEL_KW["tol"] and rp <= CHANNEL_KW["tol"]
    assert sp == int(sj)
    assert abs(ip - int(ij)) <= 0.05 * int(ij)
    assert abs(rp - float(rj)) <= 0.05 * float(rj)
    assert bool(torch.isfinite(xp[0]).all())


def test_minres_refinement_2phase_matches_jax_on_channel(channel):
    _, rj, (p1j, p2j), ij = jref.mixed_precision_minres_refinement_2phase(
        *channel["jax"], **CHANNEL_KW)
    _, rp, (p1p, p2p), ip = ref.mixed_precision_minres_refinement_2phase(
        *channel["port"], **CHANNEL_KW)
    assert float(rj) <= CHANNEL_KW["tol"] and rp <= CHANNEL_KW["tol"]
    assert (p1p, p2p) == (int(p1j), int(p2j))
    assert abs(ip - int(ij)) <= 0.05 * int(ij)


def _equilibrated_dense(dt_ops):
    """The dense saddle, its Jacobi-equilibrated f32 inner operators and D,
    as equilibrated_f32_ops hands them to the MINRES drivers."""
    Ad, Bd, Md, f, g, sol = _dense_saddle()
    Dv = 1.0 / np.sqrt(np.diag(Ad))
    As, Bs = Dv[:, None] * Ad * Dv[None, :], Bd * Dv[None, :]
    Ms = Bs @ np.linalg.inv(As) @ Bs.T
    return (Ad, Bd, Md, f, g, sol, Dv), (As, Bs, Ms)


@pytest.mark.parametrize("driver", ["minres abs", "minres deep", "2phase"])
def test_minres_drivers_match_jax_on_dense_saddle(one_torch_thread, driver):
    """Deep tolerance on the dense saddle: the MINRES drivers, with the
    inner absolute test on and off, and the 2-phase driver whose phase 1
    is cut to one loose pass so that phase 2 carries the solve."""
    (Ad, Bd, Md, f, g, sol, Dv), (As, Bs, Ms) = _equilibrated_dense(None)
    args_j = (_jax_ops(Ad, Bd, Md, jnp.float64),
              _jax_ops(As, Bs, Ms, jnp.float32), jnp.asarray(Dv),
              jnp.asarray(f), jnp.asarray(g))
    args_p = (_torch_ops(Ad, Bd, Md, torch.float64),
              _torch_ops(As, Bs, Ms, torch.float32), torch.tensor(Dv),
              torch.tensor(f), torch.tensor(g))
    if driver == "2phase":
        kw = dict(tol=1e-10, inner_tol=1e-2, max_refine=1)
        xj, rj, sj, ij = jref.mixed_precision_minres_refinement_2phase(
            *args_j, **kw)
        xp, rp, sp, ip = ref.mixed_precision_minres_refinement_2phase(
            *args_p, **kw)
        sj = tuple(int(v) for v in sj)
        assert sp[0] == 1 and sp[1] >= 1
    else:
        kw = dict(tol=1e-10 if driver == "minres deep" else 1e-5,
                  inner_tol=1e-5,
                  abs_test=(ref.DEEP_ABS_TEST if driver == "minres deep"
                            else True))
        xj, rj, sj, ij = jref.mixed_precision_minres_refinement(*args_j,
                                                                **kw)
        xp, rp, sp, ip = ref.mixed_precision_minres_refinement(*args_p,
                                                               **kw)
        sj = int(sj)
    assert float(rj) <= kw["tol"] and rp <= kw["tol"]
    assert sp == sj
    assert abs(ip - int(ij)) <= max(0.1 * int(ij), 2)
    got = np.concatenate([xp[0].numpy(), xp[1].numpy()])
    want = np.concatenate([np.asarray(xj[0]), np.asarray(xj[1])])
    scale = np.abs(sol).max()
    assert np.abs(got - want).max() <= 20 * kw["tol"] * scale
    assert np.abs(got - sol).max() <= 20 * kw["tol"] * scale


def _box():
    base = rectangle_mesh(0.5, 1.0, 1.0)
    mesh = extrude_to_tets(base, np.linspace(0, 0.5, 2))
    tol = 1e-9
    mesh.tag_boundary_by_predicate("inlet",
                                   lambda p: np.abs(p[:, :, 0]) < tol)
    mesh.tag_boundary_by_predicate(
        "outlet", lambda p: np.abs(p[:, :, 0] - 1.0) < tol)
    rest = np.setdiff1d(mesh.boundary_facets, np.concatenate(
        [mesh.boundary_tags["inlet"], mesh.boundary_tags["outlet"]]))
    mesh.boundary_tags["wall"] = rest.astype(np.int32)
    return mesh


def _box_uin(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = (16 * p[:, 1] * (1 - p[:, 1]) * p[:, 2] * (0.5 - p[:, 2])
                 / 0.25)
    return out


def _jax_hdg_tables(mj):
    """The JAX HDG model's host tables, as the port's ``assembly_cache``
    entry: (A, B, force_local, the velocity mass), built by the JAX
    package's own assembly and its model's mass quadrature
    (navier_stokes_hdg3d.py:67-80)."""
    A_np, B_np, force_local, _, _ = jax_assemble(mj.Xv, mj.Q, alpha=10.0,
                                                 nu=mj.nu)
    hd, mesh = mj.Xv.hdiv, mj.mesh
    J, detJ, _ = mesh.element_jacobians
    vol = tetrahedron_rule(2 * mj.order + 2)
    v_val, _ = hd.tabulate_elements(vol.points)
    val_p = np.einsum("ecA,eqiA->eqic", J, v_val) / detJ[:, None, None,
                                                         None]
    M_u = np.einsum("q,eqic,eqjc,e->eij", vol.weights, val_p, val_p, detJ)
    M_full = np.zeros((mesh.ne,) + A_np.shape[1:])
    M_full[:, :hd.n_basis, :hd.n_basis] = M_u
    return A_np, B_np, force_local, M_full


def test_solve_initial_refined_matches_jax_on_hdg3d_box(one_torch_thread):
    jmesh = _box()
    kw = dict(nu=0.01, inflow="inlet", outflow="outlet", wall="wall",
              uin=_box_uin, timestep=2e-3, order=2)
    mj64 = JaxHDG3D(jmesh, **kw)
    mj32 = JaxHDG3D(jmesh, dtype=jnp.float32, **kw)
    rj, sj, ij = jref.solve_initial_refined(mj64, mj32, tol=1e-8)
    # the JAX driver's own scaling: its f32 Lanczos from PRNGKey(0)
    f32 = jnp.where(mj64.free, mj64.f - mj64.A_raw(mj64.u_bc),
                    0.0).astype(jnp.float32)
    k, _ = jax_bp_scale(mj32.A, mj32.preA, f32)
    pmesh = Mesh(jmesh.points.copy(), jmesh.elements.copy(),
                 {key: np.asarray(v).copy()
                  for key, v in jmesh.boundary_tags.items()})
    # the same host tables on both sides (the f32 inner solves sit at
    # their floor here: tables 1e-16 apart move a pass's count)
    cache = {"hdg3d": _jax_hdg_tables(mj64)}
    mp64 = NavierStokesHDG3D(pmesh, device="cpu", assembly_cache=cache,
                             **kw)
    mp32 = NavierStokesHDG3D(pmesh, device="cpu", assembly_cache=cache,
                             dtype=torch.float32, **kw)
    rp, sp, ip = ref.solve_initial_refined(mp64, mp32, tol=1e-8,
                                           scale_k=float(k))
    assert rj <= 1e-8 and rp <= 1e-8
    assert sp == sj
    assert abs(ip - ij) <= 0.05 * ij
    assert mp64.stokes_bpcg_iterations == ip
    assert np.abs(mp64.u.numpy() - np.asarray(mj64.u)).max() <= 1e-6

"""Parity of the port's 2D MCS Navier-Stokes model (navier_stokes_tpu_torch)
with the JAX package: host tables, operator applies and preconditioners.

Both packages build ``NavierStokesMCS`` on ``channel_with_cylinder_mesh(0.3)``
(420 triangles; nu 1e-3, dt 1e-3, order 2, the demo's inflow), straight and
with ``curve_to_circle(..., order=3)``; the port on the CPU, where its
wrappers take the kernels' plain versions.  Tolerances (relative, 2-norm):

* host tables (A_ret, A_rc, A_cc, A_cond, M_loc, B_loc, the force vector,
  u_bc): 1e-12;
* operator applies (A, A_raw, mstar, B, BT, _Mv, convection, preMstar,
  preM): 1e-11 (sums in another order);
* A-preconditioner applies, each ``a_pre`` (jacobi, edgeblock, vertexstar,
  auxspace), additive and multicolor GS: 1e-11; the P1 embedding T, T^T
  and the smoother blocks exactly as the JAX package's;
* the projection preconditioner (its block and the whole apply): 1e-11;
* ``reconstruct_stress``: 1e-10.

The solves and steps are in tests/test_torch_mcs2d_solve.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.mesh import curved as jax_curved
from navier_stokes_tpu.mesh.generators import (
    channel_with_cylinder_mesh as jax_channel,
)
from navier_stokes_tpu.models import navier_stokes_mcs as jax_mcs
from navier_stokes_tpu.models import stokes_hybrid as jax_hybrid
from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh
from navier_stokes_tpu_torch.mesh.curved import curve_to_circle
from navier_stokes_tpu_torch.models import NavierStokesMCS, load_host_tables
from navier_stokes_tpu_torch.models import navier_stokes_mcs as port_mcs
from navier_stokes_tpu_torch.models import stokes_hybrid

MAXH = 0.3
KW = dict(nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
          timestep=1e-3, order=2)


def uin(p):
    out = np.zeros((len(p), 2))
    out[:, 0] = 1.5 * 4 * p[:, 1] * (0.41 - p[:, 1]) / 0.41**2
    return out


def force(p):
    return np.stack([np.sin(3 * p[:, 0]) * p[:, 1], np.cos(2 * p[:, 1])],
                    axis=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for PyTorch and one for numpy's BLAS: the
    suite runs several workers at once, and a thread pool per worker
    beside them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def pair():
    mj = jax_mcs.NavierStokesMCS(jax_channel(MAXH), uin=uin,
                                 volumeforce=force, **KW)
    mp = NavierStokesMCS(channel_with_cylinder_mesh(MAXH), uin=uin,
                         volumeforce=force, device="cpu", **KW)
    return mj, mp


def _x(mp, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(mp.n), rng.standard_normal(mp.Q.ndof)


# -- host tables --------------------------------------------------------------


@pytest.mark.parametrize("geometry", ["straight", "curved"])
def test_host_tables_match_jax(geometry):
    mj_mesh, mp_mesh = jax_channel(MAXH), channel_with_cylinder_mesh(MAXH)
    gj = gp = None
    if geometry == "curved":
        gj = jax_curved.curve_to_circle(mj_mesh, "cyl", (0.2, 0.2), 0.05, 3)
        gp = curve_to_circle(mp_mesh, "cyl", (0.2, 0.2), 0.05, 3)
    mj = jax_mcs.NavierStokesMCS(mj_mesh, uin=uin, geometry=gj, **KW)
    mp = NavierStokesMCS(mp_mesh, uin=uin, geometry=gp, device="cpu", **KW)
    assert mp.fb is None and mp.n == mj.n and mp.Q.ndof == mj.Q.ndof
    # the element-local blocks, straight from both assemblers
    args_j = (mj_mesh, mj.V, mj.Vhat, mj.sigma_basis, mj.Wspace, 1e-3)
    args_p = (mp_mesh, mp.V, mp.Vhat, mp.sigma_basis, mp.Wspace, 1e-3)
    if geometry == "curved":
        tj = jax_mcs._assemble_mcs_ns_local_curved(*args_j, gj)
        tp = port_mcs._assemble_mcs_ns_local_curved(*args_p, gp)
    else:
        tj = jax_mcs._assemble_mcs_ns_local(*args_j)[:3]
        tp = port_mcs._assemble_mcs_ns_local(*args_p)[:3]
    for a, b in zip(tj, tp):
        assert _rel(a, b) <= 1e-12
    assert _rel(mj.A_cond_np, mp.A_cond_np) <= 1e-12
    assert _rel(mj._M_loc_np, mp._M_loc_np) <= 1e-12
    assert _rel(mj._B_host, mp.B_loc_np) <= 1e-12
    assert _rel(mj.u_bc, mp.u_bc.numpy()) <= 1e-12
    assert _rel(mj._force_local(force), mp._force_local(force)) <= 1e-12
    np.testing.assert_array_equal(mj.Xv.element_dofs, mp.Xv.element_dofs)
    np.testing.assert_array_equal(mj.Xv.free_mask, mp.Xv.free_mask)


def test_force_and_state_carry(pair):
    mj, mp = pair
    assert _rel(mj.f, mp.f.numpy()) <= 1e-12
    u, p = _x(mp, 0)
    cache = load_host_tables({"u": u, "p": p})
    assert set(cache) == {"state"}
    m2 = NavierStokesMCS(mp.mesh, uin=uin, device="cpu",
                         assembly_cache=cache, **KW)
    np.testing.assert_array_equal(m2.u.numpy(), u)
    np.testing.assert_array_equal(m2.p.numpy(), p)
    np.testing.assert_array_equal(m2.velocity, u[: m2.V.ndof])
    with pytest.raises(ValueError):
        load_host_tables({"other": u})
    with pytest.raises(ValueError):
        NavierStokesMCS(mp.mesh, uin=uin, device="cpu",
                        preconditioner="faceblock", **KW)


# -- operators ------------------------------------------------------------------


@pytest.mark.parametrize("op", ["A", "A_raw", "mstar", "B", "_Mv",
                                "convection", "preMstar"])
def test_velocity_operators_match_jax(pair, op):
    mj, mp = pair
    u, _ = _x(mp, 1)
    u = np.asarray(mj.u_bc) + 0.1 * u
    want = np.asarray(getattr(mj, op)(jnp.asarray(u)))
    assert _rel(want, getattr(mp, op)(torch.from_numpy(u)).numpy()) <= 1e-11


@pytest.mark.parametrize("op", ["BT", "preM"])
def test_pressure_operators_match_jax(pair, op):
    mj, mp = pair
    _, p = _x(mp, 2)
    want = np.asarray(getattr(mj, op)(jnp.asarray(p)))
    assert _rel(want, getattr(mp, op)(torch.from_numpy(p)).numpy()) <= 1e-11


def test_blocks_and_embedding_match_jax(pair):
    mj, mp = pair
    for kind in ("edgeblock", "vertexstar"):
        bj = jax_hybrid.hybrid_blocks(mj.Xv, kind)
        bp = stokes_hybrid.hybrid_blocks(mp.Xv, kind)
        assert len(bj) == len(bp)
        for a, b in zip(bj, bp):
            np.testing.assert_array_equal(a, b)
    Tj, TTj = jax_hybrid.hybrid_h1_embedding(mj.Xv)
    Tp, TTp = stokes_hybrid.hybrid_h1_embedding(mp.Xv, device="cpu")
    rng = np.random.default_rng(3)
    c = rng.standard_normal(2 * mp.mesh.nv)
    x = rng.standard_normal(mp.n)
    assert _rel(Tj(jnp.asarray(c)), Tp(torch.from_numpy(c)).numpy()) <= 1e-13
    assert _rel(TTj(jnp.asarray(x)),
                TTp(torch.from_numpy(x)).numpy()) <= 1e-13
    # T^T is the exact transpose of T
    assert float(torch.dot(Tp(torch.from_numpy(c)), torch.from_numpy(x))
                 ) == pytest.approx(float(torch.dot(
                     torch.from_numpy(c), TTp(torch.from_numpy(x)))),
                     rel=1e-12)


@pytest.mark.parametrize("a_pre,gs", [
    ("jacobi", False), ("edgeblock", False), ("edgeblock", True),
    ("vertexstar", False), ("vertexstar", True), ("auxspace", False),
    ("auxspace", True)])
def test_a_preconditioners_match_jax(pair, a_pre, gs):
    """Each variant, additive and multicolor GS (the Jacobi one has no GS
    form in either package)."""
    mj, mp = pair
    pj = jax_hybrid.build_hybrid_preconditioner(
        mj.Xv, mj.A_cond_np, a_pre, mj._dirich, coarse_coefficient=1e-3,
        gs=gs, A_apply=mj.A if gs else None)
    pp = stokes_hybrid.build_hybrid_preconditioner(
        mp.Xv, mp.A_cond_np, a_pre, mp._dirich, coarse_coefficient=1e-3,
        gs=gs, A_apply=mp.A if gs else None, device="cpu")
    u, _ = _x(mp, 4)
    assert _rel(pj(jnp.asarray(u)), pp(torch.from_numpy(u)).numpy()) <= 1e-11


@pytest.mark.parametrize("part", ["block", "pre"])
def test_projection_preconditioner_matches_jax(pair, part):
    mj, mp = pair
    prej, prep = mj._pre_proj_twolevel(), mp._pre_proj_twolevel()
    if part == "block":
        prej = next(c.cell_contents for c in prej.__closure__
                    if getattr(c.cell_contents, "__name__", "") == "block")
        prep = prep.block
    _, p = _x(mp, 5)
    want = np.asarray(prej(jnp.asarray(p)))
    assert _rel(want, prep(torch.from_numpy(p)).numpy()) <= 1e-11


def test_reconstruct_stress_matches_jax(pair):
    mj, mp = pair
    u, _ = _x(mp, 6)
    want = mj.reconstruct_stress(jnp.asarray(u))
    got = mp.reconstruct_stress(torch.from_numpy(u))
    assert got.shape == (mp.mesh.ne, mp.sigma_basis.n_basis
                         + mp.Wspace.basis.n_basis)
    assert _rel(want, got) <= 1e-10

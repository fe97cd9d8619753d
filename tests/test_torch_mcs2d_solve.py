"""Parity of the port's 2D MCS model (navier_stokes_tpu_torch) with the JAX
package on ``channel_with_cylinder_mesh(0.3)``: the initial Stokes solve,
the projection and whole f64 steps.  The enclosed cavity and the
Poiseuille rectangle are in tests/test_torch_mcs2d_enclosed.py, which
imports this file's helpers.

Both packages build ``NavierStokesMCS`` from the same inputs; the port on
the CPU, where its wrappers take the kernels' plain versions.  The port's
Lanczos start vector is its own, so the BPCG solves get the JAX package's
Bramble-Pasciak k (``scale_k``) and the steps the JAX Chebyshev bounds
(``load_state``).  Tolerances:

* ``SolveInitial`` (auxspace, GS and additive, tol 1e-10): equal BPCG
  counts, the solution within 1e-8 (relative, 2-norm).  The one allowed
  exception: where the two error histories straddle the stopping threshold
  at the smaller count, each within a factor 1.5 of it, the stopping test
  is decided by the sums' order and the counts may differ by one (the
  additive channel solve: the JAX error at its last iteration is 2% under
  the threshold; the GS Poiseuille rectangle at 1e-11: 9% under it, the
  port's 31% over);
* ``Project``: ||B u|| reduced below 1e-5 of its start, the CG count
  within 1 of JAX's, the projected velocity within 1e-8;
* one and three f64 steps from the JAX solution: CG counts within 1, u
  within 1e-6 of the step's increment;
* ``reconstruct_stress`` of the solution: 1e-10.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.linalg.lanczos import (
    lanczos_eigenvalues as jax_lanczos,
)
from navier_stokes_tpu.mesh.generators import (
    channel_with_cylinder_mesh as jax_channel,
)
from navier_stokes_tpu.models.navier_stokes_mcs import (
    NavierStokesMCS as JaxNavierStokesMCS,
)
from navier_stokes_tpu.precond.chebyshev import (
    chebyshev_preconditioner as jax_chebyshev,
)
from navier_stokes_tpu.solvers.bpcg import bp_scale_factor as jax_bp_scale
from navier_stokes_tpu.solvers.cg import cg as jax_cg
from navier_stokes_tpu_torch.flagship import transient_steps
from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh
from navier_stokes_tpu_torch.models import NavierStokesMCS

TOL = 1e-10
KW = dict(nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
          timestep=1e-3, order=2)


def uin(p):
    out = np.zeros((len(p), 2))
    out[:, 0] = 1.5 * 4 * p[:, 1] * (0.41 - p[:, 1]) / 0.41**2
    return out


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


def _jax_k(mj, GS):
    f_mod = jnp.where(mj.free, mj.f - mj.A_raw(mj.u_bc), 0.0)
    return float(jax_bp_scale(mj.A, mj._preA_for(GS), f_mod)[0])


def _jax_cheb_bounds(mj):
    """The (alpha, beta) of ``mj._mass_chebyshev()``, installed in mj."""
    lams = jax_lanczos(mj._Mv, mj._preMv, mj.u_bc, 30)
    beta = 1.05 * float(jnp.max(lams))
    alpha = 0.02 * beta
    mj._mass_cheb = jax_chebyshev(mj._Mv, mj._preMv, mj.u_bc, degree=16,
                                  bounds=(alpha, beta))
    return alpha, beta


def _solve_both(mj, mp, GS, tol=TOL):
    """Both packages' SolveInitial with the JAX k; the counts must be
    equal, or differ by one where the stopping test sits on the threshold:
    at the smaller count the two error histories straddle it, each within
    a factor 1.5 of it."""
    k = _jax_k(mj, GS)
    rj = mj.SolveInitial(iterative=True, GS=GS, tol=tol, maxsteps=20000)
    rp = mp.SolveInitial(iterative=True, GS=GS, tol=tol, maxsteps=20000,
                         scale_k=k)
    assert bool(rj.converged) and rp.converged
    assert mp.stokes_bpcg_scale_k == k
    assert mp.stokes_bpcg_iterations == rp.iterations
    nj, np_ = int(rj.iterations), rp.iterations
    if nj != np_:
        n = min(nj, np_)
        ej = float(np.asarray(rj.errors)[n])
        ep = float(np.asarray(rp.errors)[n])
        assert abs(nj - np_) == 1, (nj, np_)
        lo, hi = sorted((ej, ep))
        assert tol / 1.5 <= lo < tol <= hi <= 1.5 * tol, (nj, np_, ej, ep)
    return rj, rp


@pytest.fixture(scope="module")
def channel():
    mj = JaxNavierStokesMCS(jax_channel(0.3), uin=uin, **KW)
    mp = NavierStokesMCS(channel_with_cylinder_mesh(0.3), uin=uin,
                         device="cpu", **KW)
    return dict(mj=mj, mp=mp, bounds=_jax_cheb_bounds(mj))


@pytest.mark.parametrize("GS", [True, False])
def test_solve_initial_matches_jax(channel, GS):
    mj, mp = channel["mj"], channel["mp"]
    _solve_both(mj, mp, GS)
    assert _rel(mj.u, mp.u.numpy()) <= 1e-8
    assert _rel(mj.p, mp.p.numpy()) <= 1e-8
    assert mp.stokes_bpcg_time > 0
    np.testing.assert_array_equal(mp.velocity, mp.u[: mp.V.ndof].numpy())
    np.testing.assert_array_equal(mp.pressure, -mp.p.numpy())


def _from_jax_solution(channel):
    """The port's model in the JAX model's solved state, with its
    Chebyshev bounds."""
    mj, mp = channel["mj"], channel["mp"]
    if mj.stokes_bpcg_iterations is None:
        mj.SolveInitial(iterative=True, GS=True, tol=TOL)
    mp.load_state(u=np.asarray(mj.u), p=np.asarray(mj.p),
                  cheb_bounds=channel["bounds"])
    assert mp._mass_chebyshev().bounds == pytest.approx(channel["bounds"],
                                                        rel=1e-15)
    return mj, mp


def test_reconstruct_stress_of_the_solution(channel):
    mj, mp = _from_jax_solution(channel)
    want = mj.reconstruct_stress()
    assert _rel(want, mp.reconstruct_stress()) <= 1e-10


def test_project_matches_jax(channel):
    mj, mp = _from_jax_solution(channel)
    mask = np.asarray(mj.free & mj._umask)
    v = np.asarray(mj.u) + np.where(
        mask, 0.1 * np.random.default_rng(0).standard_normal(mp.n), 0.0)
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


@functools.lru_cache(maxsize=None)
def _jax_step_fn(mj, project_tol, mstar_tol):
    """The JAX package's SIMPLE step from its pieces (make_step_fn's body),
    jitted once per model, returning the CG counts beside the new state."""
    Minv = mj._mass_chebyshev()
    pre2 = mj._pre_proj_twolevel()  # host setup, outside the trace
    mj._build_convection()

    def step(u):
        temp = jnp.where(mj.free, mj.convection(u) + mj.f - mj.A_raw(u), 0.0)
        r1 = jax_cg(mj.mstar, temp, pre=mj.preMstar, tol=mstar_tol,
                    maxsteps=2000)
        r2 = jax_cg(lambda p: mj.B(Minv(mj.BT(p))), mj.B_raw(r1.x),
                    pre=pre2, tol=project_tol, maxsteps=2000)
        temp2 = r1.x - Minv(mj.BT(r2.x))
        return u + mj.timestep * temp2, r1.iterations, r2.iterations

    return jax.jit(step)


def _jax_step(mj, u, project_tol, mstar_tol=1e-4):
    """One JAX SIMPLE step and its CG counts."""
    u_new, i1, i2 = _jax_step_fn(mj, project_tol, mstar_tol)(u)
    return u_new, {"mstar": int(i1), "project": int(i2)}


@pytest.mark.parametrize("nsteps", [1, 3])
def test_f64_steps_match_jax(channel, nsteps):
    mj, mp = _from_jax_solution(channel)
    u0 = mj.u
    u_j, counts_j = u0, []
    for _ in range(nsteps):
        u_j, c = _jax_step(mj, u_j, 1e-9)
        counts_j.append(c)
    u_p, counts_p = transient_steps(mp, nsteps, project_tol=1e-9)
    for cp, cj in zip(counts_p, counts_j):
        assert abs(cp["mstar"] - cj["mstar"]) <= 1
        assert abs(cp["project"] - cj["project"]) <= 1
    incr = np.linalg.norm(np.asarray(u_j) - np.asarray(u0))
    assert incr > 0 and bool(torch.isfinite(u_p).all())
    assert np.linalg.norm(u_p.numpy() - np.asarray(u_j)) <= 1e-6 * incr
    if nsteps == 1:
        # DoTimeStep moves the model's state by the same step
        u_before = mp.u
        mp.DoTimeStep()
        assert torch.equal(mp.u, u_p)
        mp.u = u_before

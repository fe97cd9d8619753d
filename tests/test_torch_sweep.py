"""Parity of the port's Reynolds-number ensembles
(navier_stokes_tpu_torch.parallel.sweep) with the JAX package's, in 2D.

Both packages build the model from the same inputs, the port on the CPU,
where its wrappers take the kernels' plain versions; the port's model gets
the JAX model's Chebyshev bounds (``load_state(cheb_bounds=)``: the two
Lanczos start vectors differ).  The JAX ensembles run without a device
mesh.  Tolerances (relative, 2-norm):

* Taylor-Hood on ``channel_with_cylinder_mesh(0.3)``, order 2, Jacobi: one
  ``make_viscosity_step`` at the same u0 and nu, 1e-9; the ensemble of 4
  viscosities (geomspace 1e-3..1e-2) over 2 steps row by row against
  ``run_reynolds_ensemble``, 1e-8; the member at the model's nu against
  ``DoTimeStep``, 1e-7 absolute (the JAX test's bound);
* the 2D MCS model on the same mesh (the ``eldofs`` branch of
  ``make_viscosity_step_mcs``): the nu-split tables, 1e-12 of their
  largest entry; the ensemble row by row, 1e-8; the member at the model's
  nu against ``DoTimeStep``, 1e-6 of max |u|.

The 3D model's tables and ensembles are in tests/test_torch_sweep_mcs3d.py.
"""

import functools

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
from navier_stokes_tpu.models.navier_stokes import (
    NavierStokes as JaxNavierStokes,
)
from navier_stokes_tpu.models.navier_stokes_mcs import (
    NavierStokesMCS as JaxNavierStokesMCS,
)
from navier_stokes_tpu.parallel import sweep as jax_sweep
from navier_stokes_tpu.precond.chebyshev import (
    chebyshev_preconditioner as jax_chebyshev,
)
from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh
from navier_stokes_tpu_torch.models import NavierStokes, NavierStokesMCS
from navier_stokes_tpu_torch.parallel import sweep

NUS = np.geomspace(1e-3, 1e-2, 4)
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


@functools.lru_cache(maxsize=None)
def _pair(kind):
    """(JAX model, port model) of ``kind`` ("th" or "mcs"), the JAX
    model's Chebyshev bounds in both."""
    if kind == "th":
        mj = JaxNavierStokes(jax_channel(0.3), uin=uin,
                             preconditioner="jacobi", **KW)
        mp = NavierStokes(channel_with_cylinder_mesh(0.3), uin=uin,
                          preconditioner="jacobi", device="cpu", **KW)
        Mv, preMv, u_bc = mj.Mv, mj.preMv, mj.u_bc.reshape(-1)
    else:
        mj = JaxNavierStokesMCS(jax_channel(0.3), uin=uin, **KW)
        mp = NavierStokesMCS(channel_with_cylinder_mesh(0.3), uin=uin,
                             device="cpu", **KW)
        Mv, preMv, u_bc = mj._Mv, mj._preMv, mj.u_bc
    beta = 1.05 * float(jnp.max(jax_lanczos(Mv, preMv, u_bc, 30)))
    bounds = (0.02 * beta, beta)
    mj._mass_cheb = jax_chebyshev(Mv, preMv, u_bc, degree=16, bounds=bounds)
    mp.load_state(cheb_bounds=bounds)
    return mj, mp


def test_th_viscosity_step_matches_jax():
    mj, mp = _pair("th")
    u0 = np.array(mj.u).reshape(-1)
    nu = 2e-3
    want = np.asarray(jax_sweep.make_viscosity_step(mj)(jnp.asarray(u0),
                                                         jnp.asarray(nu)))
    step = sweep.make_viscosity_step(mp)
    got = step(torch.from_numpy(u0), torch.tensor(nu, dtype=torch.float64))
    assert got.dtype == torch.float64 and got.shape == (mp.d * mp.n,)
    assert _rel(want, got.numpy()) <= 1e-9
    # a Python float viscosity gives the same step
    assert torch.equal(step(torch.from_numpy(u0), nu), got)
    assert set(mp.last_iterations) == {"mstar", "project"}


def test_th_ensemble_matches_jax_row_by_row():
    mj, mp = _pair("th")
    want = np.asarray(jax_sweep.run_reynolds_ensemble(mj, NUS, 2))
    log = []
    got = sweep.run_reynolds_ensemble(mp, NUS, 2, log=log)
    assert got.shape == (len(NUS), mp.d * mp.n)
    assert got.device == mp.u.device and got.dtype == mp.dtype
    assert bool(torch.isfinite(got).all())
    for i in range(len(NUS)):
        assert _rel(want[i], got[i].numpy()) <= 1e-8, i
    # viscosity matters
    assert float((got[0] - got[-1]).abs().max()) > 1e-8
    assert [(r["member"], r["step"]) for r in log] == [
        (i, k) for i in range(len(NUS)) for k in range(2)]
    assert all(0 < r["mstar"] < 2000 and 0 < r["project"] < 500
               for r in log)


def test_th_member_at_model_nu_matches_do_time_step():
    _, mp = _pair("th")
    u0 = mp.u
    row = sweep.run_reynolds_ensemble(mp, [mp.nu], 1)[0]
    mp.DoTimeStep()
    try:
        assert float((row - mp.u).abs().max()) < 1e-7
    finally:
        mp.u = u0


def test_mcs2d_split_tables_match_jax():
    mj, mp = _pair("mcs")
    for want, got in zip(jax_sweep.mcs_nu_split_tables(mj),
                         sweep.mcs_nu_split_tables(mp)):
        scale = max(np.abs(want).max(), 1e-300)
        assert np.abs(got - want).max() <= 1e-12 * scale
    G1, G2, G3 = sweep.mcs_nu_split_tables(mp)
    A0 = mp.nu * G1 + G2 + G3 / mp.nu
    assert np.abs(A0 - mp.A_cond_np).max() <= 1e-10 * np.abs(
        mp.A_cond_np).max()


def test_mcs2d_ensemble_matches_jax_row_by_row():
    mj, mp = _pair("mcs")
    want = np.asarray(jax_sweep.run_reynolds_ensemble_mcs(mj, NUS, 2))
    got = sweep.run_reynolds_ensemble_mcs(mp, NUS, 2)
    assert got.shape == (len(NUS), mp.n) and got.dtype == torch.float64
    for i in range(len(NUS)):
        assert _rel(want[i], got[i].numpy()) <= 1e-8, i
    assert float((got[0] - got[-1]).abs().max()) > 1e-8


def test_mcs2d_member_at_model_nu_matches_do_time_step():
    _, mp = _pair("mcs")
    u0 = mp.u
    step = sweep.make_viscosity_step_mcs(mp)
    assert set(step.tables) == {"G1", "G2", "G3", "M"}
    u1 = step(u0, mp.nu)
    mp.DoTimeStep()
    try:
        scale = float(mp.u.abs().max())
        assert float((u1 - mp.u).abs().max()) / scale < 1e-6
    finally:
        mp.u = u0

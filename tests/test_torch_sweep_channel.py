"""One step of the port's 3D MCS Reynolds-number ensemble on the straight
channel at maxh 0.6 against the JAX package's, at a viscosity away from
the model's: the size at which the nu-split tables cancel (A_ret =
A_cond + Schur0, |G1| up to 3.2e8), which the plates of
test_torch_sweep_mcs3d.py hardly show.

From u = u_bc with the JAX model's Chebyshev bounds, one
``make_viscosity_step_mcs`` step at nu = 2e-3 (nu0 = 1e-3) agrees with
JAX's within STEP_TOL relative (it prints its readings: 1.2e-9 on one
CPU thread).  The control: the same step with the nu-split and mass
applies in float32, the route of ``elem_apply_multi`` before its float64
repair, lies beyond the bound (4.3e-5).  About three minutes on one
thread: its own file, so that it runs beside the others.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.linalg.lanczos import (
    lanczos_eigenvalues as jax_lanczos,
)
from navier_stokes_tpu.mesh.generators import (
    channel_with_cylinder_mesh_3d as jax_channel_3d,
)
from navier_stokes_tpu.models.navier_stokes_mcs import (
    NavierStokesMCS as JaxNavierStokesMCS,
)
from navier_stokes_tpu.parallel import sweep as jax_sweep
from navier_stokes_tpu.precond.chebyshev import (
    chebyshev_preconditioner as jax_chebyshev,
)
from navier_stokes_tpu_torch.flagship import build_model, uin
from navier_stokes_tpu_torch.models.navier_stokes_mcs import load_host_tables
from navier_stokes_tpu_torch.ops import faceblock
from navier_stokes_tpu_torch.parallel import sweep

NU, STEP_TOL = 2e-3, 5e-9


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
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _f32_elem_apply_multi(orig):
    """``elem_apply_multi`` with every table and vector in float32."""
    def multi(self, mats_and_scales):
        apply = orig(self, [(torch.as_tensor(A).float(), c)
                            for A, c in mats_and_scales])
        return lambda u: apply(u.float()).double()

    return multi


def test_channel_step_away_from_nu0_matches_jax(monkeypatch):
    cache = {}
    mj = JaxNavierStokesMCS(
        jax_channel_3d(0.6), nu=1e-3, inflow="inlet", outflow="outlet",
        wall="wall|cyl", uin=uin, timestep=2e-3, order=2,
        preconditioner="faceblock", assembly_cache=cache)
    flat = {f"{key}_{i}": a for key, tup in cache.items()
            for i, a in enumerate(tup)}
    mp = build_model(0.6, device="cpu", curved=False,
                     assembly_cache=load_host_tables(flat))
    beta = 1.05 * float(jnp.max(jax_lanczos(mj._Mv, mj._preMv, mj.u_bc, 30)))
    bounds = (0.02 * beta, beta)
    mj._mass_cheb = jax_chebyshev(mj._Mv, mj._preMv, mj.u_bc, degree=16,
                                  bounds=bounds)
    mp.load_state(cheb_bounds=bounds)
    u0 = np.array(mj.u_bc)
    want = np.asarray(jax_sweep.make_viscosity_step_mcs(mj)(
        jnp.asarray(u0), jnp.asarray(NU)))
    nu = torch.tensor(NU, dtype=torch.float64)
    got = sweep.make_viscosity_step_mcs(mp)(torch.from_numpy(u0), nu)
    rel = _rel(want, got.numpy())
    print(f"one step at nu = {NU} against JAX: {rel:.3e} relative")
    assert rel <= STEP_TOL
    # the control: the pre-repair float32 products break the bound
    monkeypatch.setattr(
        faceblock.FaceBlockLayout, "elem_apply_multi",
        _f32_elem_apply_multi(faceblock.FaceBlockLayout.elem_apply_multi))
    f32 = sweep.make_viscosity_step_mcs(mp)(torch.from_numpy(u0), nu)
    rel32 = _rel(want, f32.numpy())
    print(f"the float32 control against JAX: {rel32:.3e} relative")
    assert rel32 > STEP_TOL

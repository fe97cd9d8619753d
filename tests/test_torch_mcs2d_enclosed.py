"""Parity of the port's 2D MCS model (navier_stokes_tpu_torch) with the JAX
package on the enclosed lid-driven cavity and the Poiseuille rectangle.

Both packages build ``NavierStokesMCS`` from the same inputs; the port on
the CPU, where its wrappers take the kernels' plain versions, solves with
the JAX package's Bramble-Pasciak k and steps with its Chebyshev bounds
(the helpers of tests/test_torch_mcs2d_solve.py).  Tolerances:

* the enclosed cavity (``cavity_mesh(0.25)``, ``outflow=""``, nu 0.01, the
  additive auxspace preconditioner, tol 1e-10): the pressure demeaned; BT
  and preM, the solution, the projection and one step within 1e-10 of
  JAX's (relative, 2-norm); equal BPCG counts (or one apart where the
  error histories straddle the threshold, as there) and CG counts within
  1;
* the Poiseuille rectangle (``rectangle_mesh(0.1, 1.0, 0.41)``, additive,
  tol 1e-11): the exact profile within 1e-6, as the JAX package's own
  test, and JAX's solution within 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_mcs2d_solve import (
    _jax_cheb_bounds,
    _jax_step,
    _rel,
    _solve_both,
    one_torch_thread,  # noqa: F401  (the module's thread limits)
    uin,
)

from navier_stokes_tpu.fem.quadrature import triangle_rule
from navier_stokes_tpu.mesh.generators import cavity_mesh as jax_cavity
from navier_stokes_tpu.mesh.generators import rectangle_mesh as jax_rect
from navier_stokes_tpu.models.navier_stokes_mcs import (
    NavierStokesMCS as JaxNavierStokesMCS,
)
from navier_stokes_tpu_torch.flagship import transient_steps
from navier_stokes_tpu_torch.mesh import cavity_mesh, rectangle_mesh
from navier_stokes_tpu_torch.models import NavierStokesMCS


def lid(p):
    out = np.zeros((len(p), 2))
    out[:, 0] = 16.0 * (p[:, 0] * (1.0 - p[:, 0])) ** 2
    return out


def test_enclosed_cavity_matches_jax():
    kw = dict(nu=0.01, inflow="lid", outflow="", wall="wall", uin=lid,
              timestep=2e-3, order=2)
    mj = JaxNavierStokesMCS(jax_cavity(0.25), **kw)
    mp = NavierStokesMCS(cavity_mesh(0.25), device="cpu", **kw)
    x = np.random.default_rng(1).standard_normal(mp.Q.ndof)
    for op in ("BT", "preM"):
        assert _rel(getattr(mj, op)(jnp.asarray(x)),
                    getattr(mp, op)(torch.from_numpy(x)).numpy()) <= 1e-10
    _solve_both(mj, mp, False)
    assert abs(float(mp.p.mean())) <= 1e-12 * float(mp.p.abs().max())
    assert _rel(mj.u, mp.u.numpy()) <= 1e-10
    assert _rel(mj.p, mp.p.numpy()) <= 1e-10
    bounds = _jax_cheb_bounds(mj)
    mp.load_state(cheb_bounds=bounds)
    vj = mj.Project(mj.u)
    vp = mp.Project(mp.u)
    assert _rel(vj, vp.numpy()) <= 1e-10
    u_j, cj = _jax_step(mj, mj.u, 1e-9)
    u_p, cp = transient_steps(mp, 1, project_tol=1e-9)
    assert abs(cp[0]["mstar"] - cj["mstar"]) <= 1
    assert abs(cp[0]["project"] - cj["project"]) <= 1
    assert _rel(u_j, u_p.numpy()) <= 1e-10


def test_poiseuille_rectangle_exact_and_matches_jax():
    """tests/test_navier_stokes_mcs.py's Poiseuille check, in the port and
    against the JAX solve."""
    kw = dict(nu=0.01, inflow="inlet", outflow="outlet", wall="wall",
              uin=uin, timestep=1e-3, order=2)
    mj = JaxNavierStokesMCS(jax_rect(0.1, length=1.0, height=0.41), **kw)
    mp = NavierStokesMCS(rectangle_mesh(0.1, length=1.0, height=0.41),
                         device="cpu", **kw)
    _solve_both(mj, mp, False, tol=1e-11)
    assert _rel(mj.u, mp.u.numpy()) <= 1e-8
    mesh, V = mp.mesh, mp.V
    q = triangle_rule(6)
    vals_ref, _ = V.basis.tabulate(q.points)
    J, detJ, _ = mesh.element_jacobians
    ue = mp.velocity[V.element_dofs] * V.element_signs
    val_p = np.einsum("ecA,qiA->eqic", J, vals_ref) / detJ[:, None, None,
                                                            None]
    uq = np.einsum("eqic,ei->eqc", val_p, ue)
    qpts = mesh.points[mesh.elements[:, 0]][:, None, :] + np.einsum(
        "eab,qb->eqa", J, q.points)
    exact_x = 1.5 * 4 * qpts[..., 1] * (0.41 - qpts[..., 1]) / 0.41**2
    assert np.abs(uq[..., 0] - exact_x).max() < 1e-6
    assert np.abs(uq[..., 1]).max() < 1e-6
    assert float(torch.linalg.norm(mp.B_raw(mp.u))) < 1e-7

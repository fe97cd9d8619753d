"""Krylov-subspace exponential integrator for linear parabolic problems.

Counterpart of ``navier_stokes_tpu/timestepping/exponential.py`` (the
reference's heat solver, heat.py:74-146): each large time step builds a
small Krylov basis from ``subspace_dimension - 1`` implicit-Euler-like
substeps, projects the mass and diffusion operators onto it and advances
the reduced linear ODE by one s-stage Gauss IRK step (order 2s).

The JAX package traces the step into one program; here the substeps' inner
solves are host-driven CG loops (solvers/cg.py) and the basis work is a
handful of small products on the vectors' device.
"""

from __future__ import annotations

import torch

from ..linalg.dense import dense_solve
from .orthonormalization import orthonormalize
from .runge_kutta import RungeKuttaWeights, linear_implicit_runge_kutta_step

__all__ = ["krylov_exponential_step"]


def krylov_exponential_step(
    T: torch.Tensor,
    diffusion_apply,
    mass_apply,
    heat_solve,
    weights: RungeKuttaWeights,
    time_step: float,
    subspace_dimension: int = 5,
) -> torch.Tensor:
    """Advance T by one large ``time_step`` (reference heat.py:81-146).

    ``heat_solve(r)`` applies (M + dt_sub K)^{-1} on free dofs (dt_sub =
    time_step / subspace_dimension); ``diffusion_apply``/``mass_apply`` are
    the unconstrained operators.
    """
    m = subspace_dimension
    dt_sub = time_step / m

    norm0 = torch.linalg.norm(T)
    basis = [T]
    Tc = T
    for _ in range(1, m):
        r = diffusion_apply(Tc)
        Tc = Tc - dt_sub * heat_solve(r)
        basis.append(Tc)
    B = orthonormalize(torch.stack(basis), tries=3)

    DB = torch.stack([diffusion_apply(row) for row in B])  # (m, n)
    MB = torch.stack([mass_apply(row) for row in B])
    D_small = B @ DB.T  # D_small[r, c] = <basis_r, D basis_c>
    M_small = B @ MB.T

    evolution = -dense_solve(M_small, D_small)

    y0 = torch.zeros(m, dtype=T.dtype, device=T.device)
    y0[0] = norm0
    y1 = linear_implicit_runge_kutta_step(weights, evolution, y0, time_step)
    return y1 @ B

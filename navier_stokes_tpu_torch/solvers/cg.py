"""Preconditioned conjugate gradients on tensors.

Counterpart of ``navier_stokes_tpu/solvers/cg.py`` (the inner mstar and
projection inverses of the transient step).  The JAX package runs the
iteration as one ``lax.while_loop`` on the device; here the vector work and
the scalar recurrence (alpha, beta as 0-d tensors, in the vectors' own
precision) stay on the device, and the convergence test before each
iteration reads ONE scalar back to the host: rho = <r, z>.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SolverResult", "cg", "cg_solve"]


@dataclass
class SolverResult:
    """x: solution tensor; iterations: int; errors: (maxsteps+1,) relative
    error history (NaN past convergence); err0: initial error
    sqrt|<r0, pre r0>|; converged: bool."""

    x: torch.Tensor
    iterations: int
    errors: np.ndarray
    err0: float
    converged: bool


def cg(A, b: torch.Tensor, pre=None, x0: torch.Tensor | None = None,
       tol: float = 1e-8, maxsteps: int = 200,
       rel_err: bool = True, group=None) -> SolverResult:
    """Solve A x = b with PCG; ``A``, ``pre`` are callables on tensors.

    Same threshold as the JAX package -- sqrt|rho| <= tol * err0 (or
    ``tol`` alone with ``rel_err=False``), tested before each iteration --
    so iteration counts are comparable.  ``group``: the vectors are each
    rank's block of a vector split over a process group; every inner
    product is then summed over it (``linalg/pytree.tdot``)."""
    if group is None:
        dot = torch.dot
    else:
        def dot(a, c):
            return group.all_reduce(torch.dot(a, c))
    if pre is None:
        pre = lambda v: v
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - A(x0)

    z = pre(r)
    rho = dot(r, z)
    rho_h = float(rho)
    err0 = math.sqrt(abs(rho_h))
    errors = np.full(maxsteps + 1, np.nan)
    errors[0] = 1.0
    threshold = tol * (err0 if rel_err else 1.0)

    p = z
    it = 0
    while math.sqrt(abs(rho_h)) > threshold and it < maxsteps:
        q = A(p)
        alpha = rho / dot(p, q)
        x = torch.addcmul(x, p, alpha)
        r = torch.addcmul(r, q, -alpha)
        z = pre(r)
        rho_new = dot(r, z)
        p = z + (rho_new / rho) * p
        rho = rho_new
        rho_h = float(rho)  # the iteration's one host read
        it += 1
        errors[it] = math.sqrt(abs(rho_h)) / err0 if err0 else math.nan
    converged = math.sqrt(abs(rho_h)) <= threshold
    return SolverResult(x=x, iterations=it, errors=errors, err0=err0,
                        converged=converged)


def cg_solve(A, b, pre=None, tol=1e-8, maxsteps=200):
    """Convenience: just the solution (for inner inverses)."""
    return cg(A, b, pre=pre, tol=tol, maxsteps=maxsteps).x

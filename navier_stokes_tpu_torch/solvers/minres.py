"""Preconditioned MINRES on tensors and tuples of tensors.

Counterpart of ``navier_stokes_tpu/solvers/minres.py`` (itself the
reference's hand-written MINRES, after M. Kolmbauer's thesis):
preconditioned Lanczos three-term recurrence + Givens rotations + the
residual-norm recurrence ``res_norm = |s_new| * res_norm_old``, with the
same dual stopping tests and per-iteration relative-error history.

The JAX package runs the loop as one ``lax.while_loop`` on the device.  Here
the vector work stays on the device and the scalar recurrence runs on the
host in the vectors' own precision (numpy float32 / float64 scalars, as the
JAX loop computes them): each iteration reads back two inner products.
Under a profiler the solve is the span ``minres`` (its ``iterations`` set
at exit) around ``minres.apply``, ``minres.pre`` and ``minres.read`` spans
(``utils/tracing.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..linalg.pytree import _leaves, taxpy, tdot, tscale, tsub, tzeros_like
from ..utils.tracing import traced, wrap

__all__ = ["SolverResult", "minres"]


@dataclass
class SolverResult:
    """x: solution (a tensor for a bare-tensor rhs, else a tuple);
    iterations: int; errors: (maxsteps+1,) relative error history (NaN
    past convergence); err0: initial error; converged."""

    x: tuple | torch.Tensor
    iterations: int
    errors: np.ndarray
    err0: float
    converged: bool


@traced("minres")
def minres(mat, rhs, pre=None, sol=None, maxsteps: int = 100,
           initialize: bool = True, tol: float = 1e-7,
           abs_test: bool = True, group=None) -> SolverResult:
    """Solve mat x = rhs (symmetric, possibly indefinite) with PMINRES.

    ``mat``/``pre`` act on a tensor or on tuples of tensors, as ``rhs``
    is one; ``pre`` must be SPD.
    ``initialize=False`` keeps ``sol`` as the initial guess.
    ``abs_test=False`` drops the absolute stopping test ``res_norm <= tol``
    (a correction solve whose rhs is already tiny would otherwise stop at
    iteration one without contracting anything).  ``group``: the vectors
    are each rank's block of a vector split over a process group, and
    every inner product is summed over it (``linalg/pytree.tdot``)."""
    if pre is None:
        pre = lambda v: v
    mat, pre, read = (wrap("minres.apply", mat), wrap("minres.pre", pre),
                      wrap("minres.read", torch.Tensor.item))
    # a bare tensor is one block (the solution is then a tensor); any
    # other sequence of blocks is taken as a tuple
    if not isinstance(rhs, torch.Tensor):
        rhs = tuple(rhs)
    if sol is None or initialize:
        u = tzeros_like(rhs) if sol is None else tzeros_like(sol)
        v = rhs
    else:
        u = sol if isinstance(sol, torch.Tensor) else tuple(sol)
        v = tsub(rhs, mat(u))
    sdt = np.dtype(str(_leaves(rhs)[0].dtype).replace("torch.", ""))
    one = sdt.type(1.0)

    def scalar(t):
        return sdt.type(read(t))

    z = pre(v)
    gamma = np.sqrt(scalar(tdot(z, v, group)))
    z = tscale(float(one / gamma), z)
    v = tscale(float(one / gamma), v)

    err0 = gamma
    errors = np.full(maxsteps + 1, np.nan, sdt)
    errors[0] = 1.0
    v_old, w, w_old = tzeros_like(v), tzeros_like(v), tzeros_like(v)
    eta_old = gamma
    c_old, c = one, one
    s_old, s = sdt.type(0.0), sdt.type(0.0)
    res_norm = gamma
    k = 1
    done = False
    while k < maxsteps + 1 and not done:
        mz = mat(z)
        delta = scalar(tdot(mz, z, group))
        v_new = taxpy(float(-delta), v, mz)
        v_new = taxpy(float(-gamma), v_old, v_new)
        z_new = pre(v_new)
        gamma_new = np.sqrt(scalar(tdot(z_new, v_new, group)))
        z_new = tscale(float(one / gamma_new), z_new)
        v_new = tscale(float(one / gamma_new), v_new)

        alpha0 = c * delta - c_old * s * gamma
        alpha1 = np.sqrt(alpha0 * alpha0 + gamma_new * gamma_new)
        alpha2 = s * delta + c_old * c * gamma
        alpha3 = s_old * gamma

        c_new = alpha0 / alpha1
        s_new = gamma_new / alpha1

        w_new = taxpy(float(-alpha3), w_old, z)
        w_new = taxpy(float(-alpha2), w, w_new)
        w_new = tscale(float(one / alpha1), w_new)

        u = taxpy(float(c_new * eta_old), w_new, u)
        eta_old = -s_new * eta_old

        res_norm = np.abs(s_new) * res_norm
        errors[k] = res_norm / err0
        # same dual stopping tests as the reference minres
        done = bool(res_norm < tol * err0)
        if abs_test:
            done = done or bool(res_norm <= tol)

        v_old, v, w_old, w, z = v, v_new, w, w_new, z_new
        c_old, c, s_old, s, gamma = c, c_new, s, s_new, gamma_new
        k += 1
    return SolverResult(x=u, iterations=k - 1, errors=errors, err0=err0,
                        converged=done)

"""Gauss-collocation implicit Runge-Kutta (any number of stages).

Counterpart of ``navier_stokes_tpu/timestepping/runge_kutta.py``
(reference runge_kutta_method.py): the Butcher tableau of the s-stage Gauss
method (order 2s) from Gauss-Legendre nodes, with the weights integrated
exactly by Gauss quadrature of the Lagrange basis (host numpy, f64), and
the linear-ODE stage system built with one Kronecker product and solved
densely on the matrix's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..linalg.dense import dense_solve

__all__ = ["RungeKuttaWeights", "implicit_runge_kutta_weights",
           "linear_implicit_runge_kutta_step"]


@dataclass(frozen=True)
class RungeKuttaWeights:
    """Butcher tableau (a, b, c) of the `stages`-stage Gauss method."""

    a: np.ndarray  # (s, s)
    b: np.ndarray  # (s,)
    c: np.ndarray  # (s,)

    @property
    def stages(self) -> int:
        return len(self.b)


def _lagrange_vals(c: np.ndarray, x: np.ndarray) -> np.ndarray:
    """ell_j(x) for the Lagrange basis over nodes c. Returns (len(x), s)."""
    s = len(c)
    out = np.ones((len(x), s))
    for j in range(s):
        for m in range(s):
            if m != j:
                out[:, j] *= (x - c[m]) / (c[j] - c[m])
    return out


def implicit_runge_kutta_weights(stages: int = 3) -> RungeKuttaWeights:
    """Gauss method tableau: c = mapped Gauss-Legendre nodes on [0,1],
    a_ij = int_0^{c_i} ell_j, b_j = int_0^1 ell_j (reference
    runge_kutta_method.py:10-23)."""
    nodes, _ = np.polynomial.legendre.leggauss(stages)
    c = (nodes + 1.0) / 2.0
    # exact integration of degree-(s-1) polynomials
    gx, gw = np.polynomial.legendre.leggauss(stages)
    gx01 = (gx + 1.0) / 2.0
    gw01 = gw / 2.0
    b = np.einsum("q,qj->j", gw01, _lagrange_vals(c, gx01))
    a = np.zeros((stages, stages))
    for i in range(stages):
        xs = c[i] * gx01
        ws = c[i] * gw01
        a[i] = np.einsum("q,qj->j", ws, _lagrange_vals(c, xs))
    return RungeKuttaWeights(a=a, b=b, c=c)


def linear_implicit_runge_kutta_step(weights: RungeKuttaWeights,
                                     matrix: torch.Tensor,
                                     value: torch.Tensor,
                                     step_width: float) -> torch.Tensor:
    """One Gauss-IRK step for the linear ODE y' = M y (exact stage solve).

    Solves (I - h a (x) M) k = 1_s (x) (M y), then y+ = y + h sum_i b_i k_i
    (reference runge_kutta_method.py:26-59)."""
    M, y = matrix.contiguous(), value
    s = weights.stages
    m = M.shape[0]
    a = torch.as_tensor(weights.a, dtype=M.dtype, device=M.device)
    b = torch.as_tensor(weights.b, dtype=M.dtype, device=M.device)
    lhs = (torch.eye(s * m, dtype=M.dtype, device=M.device)
           - step_width * torch.kron(a, M))
    My = M @ y
    rhs = My.repeat(s)
    k = dense_solve(lhs, rhs).reshape(s, m)
    return y + step_width * torch.einsum("i,ij->j", b, k)

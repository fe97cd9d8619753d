"""Small dense solves.

Counterpart of ``navier_stokes_tpu/linalg/dense.py``: the heat
integrator's 5x5 projected evolution matrix (reference heat.py:120-124) and
the s*m x s*m Gauss-IRK stage system (reference
runge_kutta_method.py:44-45) are solved with ``torch.linalg.solve`` in the
inputs' own precision, the JAX package's branch for every backend but the
TPU.  Its f32 LU with f64 iterative refinement works around the TPU's lack
of an f64 LU and is not ported.
"""

from __future__ import annotations

import torch

__all__ = ["dense_solve"]


def dense_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for a small dense A (b a vector or a matrix)."""
    return torch.linalg.solve(A, b)

"""Gram-Schmidt orthonormalization of a small vector batch.

Counterpart of ``navier_stokes_tpu/timestepping/orthonormalization.py``
(reference orthonormalization.py:5-16): ``tries`` full passes of classical
Gram-Schmidt with normalization over the rows of a (k, n) tensor, k small
(the 5 Krylov vectors of the heat step), on the tensor's device.
"""

from __future__ import annotations

import torch

__all__ = ["orthonormalize"]


def orthonormalize(basis: torch.Tensor, tries: int = 3) -> torch.Tensor:
    """Orthonormalize the rows of ``basis`` (k, n) by repeated CGS."""
    k = basis.shape[0]
    for _ in range(tries):
        rows = []
        for i in range(k):
            v = basis[i]
            if rows:
                q = torch.stack(rows)
                v = v - q.T @ (q @ v)
            v = v / torch.linalg.norm(v)
            rows.append(v)
        basis = torch.stack(rows)
    return basis

"""Jacobi / block-Jacobi preconditioners (batched dense block inverses).

Counterpart of ``navier_stokes_tpu/precond/jacobi.py``.  Block inverses are
computed once on the host in float64 and shipped to the device; the apply is
gather -> batched block matvec -> scatter-add, the batched product through
the hand-written kernels like every other table apply: float32 blocks
through :func:`~navier_stokes_tpu_torch.ops.block_mv.make_table_apply`
(``block_mv``), float64 blocks through
:func:`~navier_stokes_tpu_torch.ops.local_mv.batched_local_matvec`, which
takes doubles on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.assembly import assemble_csr
from ..ops.block_mv import make_table_apply
from ..ops.local_mv import batched_local_matvec

__all__ = ["jacobi", "block_jacobi", "extract_blocks_from_local",
           "extract_blocks_csr"]


def jacobi(diag: torch.Tensor, free_mask: torch.Tensor | None = None):
    """Pointwise Jacobi: x -> x / diag, zero on constrained dofs."""
    if free_mask is None:
        inv = 1.0 / diag
        return lambda x: inv * x
    inv = 1.0 / torch.where(free_mask, diag, 1.0)
    return lambda x: torch.where(free_mask, inv * x, 0.0)


def block_jacobi(blocks_dofs: np.ndarray, block_mats: np.ndarray, ndof: int,
                 dtype=torch.float64, device=None):
    """Additive block-Jacobi from padded dof blocks.

    ``blocks_dofs``: (nblocks, bmax) int, padded with -1.
    ``block_mats``: (nblocks, bmax, bmax) local matrices (rows/cols of the
    global operator restricted to each block; padding rows/cols must be
    identity).  Overlapping blocks are summed (additive Schwarz).  The
    inverses are taken on the host in float64 and stored in ``dtype``."""
    device = resolve_device(device)
    inv = np.linalg.inv(np.asarray(block_mats, np.float64))
    if dtype == torch.float64:
        table = torch.as_tensor(inv, device=device).contiguous()
        product = lambda xb: batched_local_matvec(table, xb)
    else:
        product = make_table_apply(inv, store_dtype=dtype, device=device)
    dofs = torch.as_tensor(np.asarray(blocks_dofs, np.int64), device=device)
    pad = dofs < 0
    safe = torch.where(pad, 0, dofs)
    flat = safe.reshape(-1)

    def apply(x):
        xb = torch.where(pad, 0.0, x[safe])
        yb = torch.where(pad, 0.0, product(xb.contiguous()))
        return x.new_zeros(ndof).index_add_(0, flat, yb.reshape(-1))

    return apply


def extract_blocks_csr(A_csr, blocks_padded: np.ndarray) -> np.ndarray:
    """(nblocks, bmax, bmax) dense sub-blocks of the CSR matrix; padding
    rows/cols are identity.  ``blocks_padded``: (nblocks, bmax) int,
    -1-padded.  (The numpy route of the JAX package's
    ``utils/native.extract_blocks_csr``.)"""
    nblocks, bmax = blocks_padded.shape
    out = np.tile(np.eye(bmax), (nblocks, 1, 1))
    A = A_csr.tocsc()
    for i in range(nblocks):
        b = blocks_padded[i]
        b = b[b >= 0]
        out[i, : len(b), : len(b)] = A[b][:, b].toarray()
    return out


def extract_blocks_from_local(a_local: np.ndarray, eldofs: np.ndarray,
                              blocks: list[np.ndarray],
                              ndof: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: padded (dofs, dense block) pairs for :func:`block_jacobi`
    by restricting the globally assembled operator to each dof block."""
    A = assemble_csr(a_local, eldofs, ndof)
    bmax = max(len(b) for b in blocks)
    dofs = -np.ones((len(blocks), bmax), dtype=np.int32)
    for i, b in enumerate(blocks):
        dofs[i, : len(b)] = np.asarray(b, dtype=np.int32)
    return dofs, extract_blocks_csr(A, dofs)

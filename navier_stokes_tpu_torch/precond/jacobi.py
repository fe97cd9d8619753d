"""Jacobi / block-Jacobi preconditioners (batched dense block inverses).

Counterpart of ``navier_stokes_tpu/precond/jacobi.py``.  Block inverses are
computed once in float64 -- on the host (:func:`block_jacobi`, as the JAX
package), or extracted from the assembled operator and inverted on the
device chunk by chunk (:func:`block_inverses`, for tables of GB size such
as the 3D HDG vertex stars) -- and stored in the apply's dtype; the apply
is gather -> batched block matvec -> deterministic scatter-add
(ops/assembly.ScatterPlan), the batched product through the hand-written
kernels like every other table apply: float32 blocks through
:func:`~navier_stokes_tpu_torch.ops.block_mv.make_table_apply`
(``block_mv``), float64 blocks through
:func:`~navier_stokes_tpu_torch.ops.local_mv.batched_local_matvec`, which
takes doubles on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.assembly import ScatterPlan, assemble_csr
from ..ops.block_mv import make_table_apply
from ..ops.local_mv import batched_local_matvec
from ..utils import native

__all__ = ["jacobi", "block_jacobi", "block_jacobi_inverses",
           "block_inverses", "padded_blocks", "extract_blocks_from_local",
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
    inverses are taken on the host in float64 and stored in ``dtype``;
    ``apply.table`` is the stored table."""
    inv = np.linalg.inv(np.asarray(block_mats, np.float64))
    return block_jacobi_inverses(blocks_dofs, torch.from_numpy(inv), ndof,
                                 dtype, device)


def block_jacobi_inverses(blocks_dofs: np.ndarray, inv: torch.Tensor,
                          ndof: int, dtype=torch.float64, device=None):
    """:func:`block_jacobi` from its (nblocks, bmax, bmax) block inverses,
    stored in ``dtype`` on ``device`` (no copy when ``inv`` is that
    already).  ``apply.table`` is the stored table."""
    device = resolve_device(device)
    if dtype == torch.float64:
        table = inv.to(device=device, dtype=torch.float64).contiguous()
        product = lambda xb: batched_local_matvec(table, xb)
    else:
        product = make_table_apply(inv, store_dtype=dtype, device=device)
        table = product.table
    dofs = torch.as_tensor(np.asarray(blocks_dofs, np.int64), device=device)
    pad = dofs < 0
    safe = torch.where(pad, 0, dofs)
    scatter = ScatterPlan(dofs, ndof)  # overlapping blocks: summed in order

    def apply(x):
        xb = torch.where(pad, 0.0, x[safe])
        return scatter(product(xb.contiguous()))

    apply.table = table
    return apply


def padded_blocks(blocks: list[np.ndarray]) -> np.ndarray:
    """(nblocks, bmax) int32 dof table of ``blocks``, padded with -1."""
    bmax = max(len(b) for b in blocks)
    dofs = -np.ones((len(blocks), bmax), dtype=np.int32)
    for i, b in enumerate(blocks):
        dofs[i, : len(b)] = np.asarray(b, dtype=np.int32)
    return dofs


def block_inverses(A_csr, blocks_padded: np.ndarray, dtype=torch.float64,
                   device=None, chunk_entries: int = 1 << 24) -> torch.Tensor:
    """(nblocks, bmax, bmax) inverses of the dense sub-blocks of ``A_csr``
    on ``blocks_padded`` ((nblocks, bmax), -1-padded; padding rows and
    columns identity), stored in ``dtype`` on ``device``.

    The blocks are looked up on the device (the stored entries, sorted by
    (row, column), searched for each block's pairs, as
    :func:`extract_blocks_csr`), rounded to ``dtype`` as the JAX package's
    callers round them before ``block_jacobi``, and inverted in float64 by
    ``torch.linalg.inv``, about ``chunk_entries`` entries at a time, so that
    the host never holds the padded table (16 GB in f64 for the vertex
    stars of the 3D HDG channel at maxh 0.09)."""
    device = resolve_device(device)
    A = A_csr.tocsr(copy=True)
    A.sum_duplicates()
    ncol = int(A.shape[1])
    keys_np = (np.repeat(np.arange(A.shape[0], dtype=np.int64),
                         np.diff(A.indptr)) * ncol + A.indices)
    if not len(keys_np):  # an empty operator: look up nothing
        keys_np = np.array([-2], np.int64)
        data_np = np.zeros(1)
    else:
        data_np = A.data
    keys = torch.as_tensor(keys_np, device=device)
    data = torch.as_tensor(data_np, device=device).to(torch.float64)
    dofs = torch.as_tensor(np.asarray(blocks_padded, np.int64), device=device)
    nblk, bmax = dofs.shape
    table = torch.empty((nblk, bmax, bmax), dtype=dtype, device=device)
    chunk = max(1, chunk_entries // max(bmax * bmax, 1))
    for c0 in range(0, nblk, chunk):
        d = dofs[c0: c0 + chunk]
        rows, cols = d[:, :, None], d[:, None, :]
        real = (rows >= 0) & (cols >= 0)
        query = torch.where(real, rows * ncol + cols, -1)
        pos = torch.searchsorted(keys, query).clamp_(max=keys.numel() - 1)
        hit = real & (keys[pos] == query)
        blk = torch.where(hit, data[pos], 0.0)
        del query, pos, hit, real
        blk = blk + torch.diag_embed((d < 0).to(torch.float64))
        blk = blk.to(dtype).to(torch.float64)
        if blk.is_cuda:
            inv = torch.linalg.inv(blk)
        else:
            # one block at a time: the batched CPU inverse (MKL) has hung
            # on large blocks with several intra-op threads
            inv = torch.stack([torch.linalg.inv(b) for b in blk])
        table[c0: c0 + chunk] = inv.to(dtype)
        del blk, inv
    return table


def extract_blocks_csr(A_csr, blocks_padded: np.ndarray) -> np.ndarray:
    """(nblocks, bmax, bmax) dense sub-blocks of the CSR matrix; padding
    rows/cols are identity.  ``blocks_padded``: (nblocks, bmax) int,
    -1-padded.  (The numpy route of the JAX package's
    ``utils/native.extract_blocks_csr``.)  Every entry is looked up at once:
    the stored entries, sorted by (row, column), are searched for each
    block's (row, column) pairs."""
    blocks_padded = np.asarray(blocks_padded, np.int64)
    nblocks, bmax = blocks_padded.shape
    A = A_csr.tocsr(copy=True)
    A.sum_duplicates()  # canonical: sorted column indices, no duplicates
    ncol = np.int64(A.shape[1])
    keys = (np.repeat(np.arange(A.shape[0], dtype=np.int64),
                      np.diff(A.indptr)) * ncol + A.indices)
    rows = blocks_padded[:, :, None]
    cols = blocks_padded[:, None, :]
    real = (rows >= 0) & (cols >= 0)
    query = np.where(real, rows * ncol + cols, -1)
    pos = np.minimum(np.searchsorted(keys, query), max(len(keys) - 1, 0))
    hit = real & (keys[pos] == query) if len(keys) else np.zeros_like(real)
    out = np.where(hit, A.data[pos] if len(keys) else 0.0, 0.0)
    pad = np.arange(bmax)[None, :] >= (blocks_padded >= 0).sum(1)[:, None]
    out[:, np.arange(bmax), np.arange(bmax)] += pad
    return out


def extract_blocks_from_local(a_local: np.ndarray, eldofs: np.ndarray,
                              blocks: list[np.ndarray],
                              ndof: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: padded (dofs, dense block) pairs for :func:`block_jacobi`
    by restricting the globally assembled operator to each dof block.

    Uses the C++ meshkit kernel when available, as the JAX package does
    (``utils/native.py``), the numpy route :func:`extract_blocks_csr`
    otherwise; tools/meshkit_setup_ab.py times the two inside real
    setups."""
    A = assemble_csr(a_local, eldofs, ndof)
    dofs = padded_blocks(blocks)
    return dofs, native.extract_blocks_csr(A, dofs)

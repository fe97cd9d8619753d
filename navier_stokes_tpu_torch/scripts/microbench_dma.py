"""Microbenchmark: how the table bytes of the batched block matvec are best
brought on chip.

Counterpart of ``scripts/microbench_dma.py``.  Every variant computes
y[b, i] = sum_j A[b, i, j] x[b, j] on the same synthetic bench-shaped table
((7740, 54, 54) f32 blocks, 90.3 MB, from ``np.random.default_rng(0)``); the
compute is negligible, so a variant's time says how well its copies keep
device memory busy:

  1. library   -- ``torch.bmm`` and ``torch.einsum`` on the table (the
                  ceiling a library call reaches; outside any kernel)
  2. rows=R    -- ``block_mv``'s kernel at four CTA sizes (R output rows per
                  CTA, per-thread 16-byte loads into shared memory)
  3. splitK    -- the table pre-split into K consecutive-tile operand
                  arrays, ONE launch, K table streams in flight per CTA
  4. mega      -- K tiles per CTA as one stretch in ONE bulk asynchronous
                  copy (fewer, larger copies)
  5. ring      -- a persistent grid, each CTA keeping nbuf bulk asynchronous
                  copies in flight through a ring of shared-memory stages

One line per variant: milliseconds (median of 25 calls, CUDA events, the L2
cache flushed before each), GB/s of table bytes, the share of the card's
3.35 TB/s, and the largest absolute deviation from the plain PyTorch version
(and whether the result is bitwise equal to ``block_mv``'s).  A variant that
fails raises.  On the CPU (``device="cpu"``) the wrappers take their plain
versions and no time is taken.

Run: python -m navier_stokes_tpu_torch.scripts.microbench_dma [nblk [nb]]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..device import resolve_device
from ..ops import block_mv as bm
from ..ops import stream_mv as sm
from ..utils.timers import Timer

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
ROWS = (64, 192, 432, 864)  # CTA sizes of the rows sweep
SPLIT_K, SPLIT_TILES = (2, 4, 8), (128, 256)
MEGA_K, MEGA_ROWS = (2, 4), (32, 128)
RING_NBUF, RING_ROWS = (2, 4, 8), (64, 128)
TOL = 1e-4  # max abs error against the plain version, f32 on N(0,1) entries


def variants(A: torch.Tensor):
    """(label, wrapper name, apply) for every variant on the table ``A``;
    the packing a variant needs happens here, outside its timed apply."""
    nblk, m, k = A.shape
    out = [
        ("torch.bmm (AoS)", "library",
         lambda x: torch.bmm(A, x[:, :, None])[:, :, 0]),
        ("torch.einsum (AoS)", "library", lambda x: bm.block_mv_plain(A, x)),
        ("block_mv", "block_mv", lambda x: bm.block_mv(A, x)),
    ]
    for rows in ROWS:
        if sm.rows_smem_bytes(rows, m, k) <= sm.SMEM_OPT_IN:
            out.append((f"rows={rows}", "block_mv_rows",
                        lambda x, r=rows: sm.block_mv_rows(A, x, r)))
    for ns in SPLIT_K:
        for tile in SPLIT_TILES:
            out.append((f"splitK k={ns} tile={tile}", "block_mv_splitk",
                        sm.make_bmv_splitk_seq(A, ns, tile)))
    for kt in MEGA_K:
        for rows in MEGA_ROWS:
            out.append((f"mega k={kt} rows={rows}", "block_mv_mega",
                        lambda x, kt=kt, r=rows: sm.block_mv_mega(A, x, kt,
                                                                  r)))
    for nbuf in RING_NBUF:
        for rows in RING_ROWS:
            out.append((f"ring nbuf={nbuf} rows={rows}", "block_mv_ring",
                        lambda x, n=nbuf, r=rows: sm.block_mv_ring(A, x, n,
                                                                   r)))
    return out


def main(nblk: int = 7740, nb: int = 54, device=None):
    """Run every variant; returns one dict per variant: ``label``,
    ``kernel`` (the wrapper, or "library"), ``ms`` (None on the CPU),
    ``gbps``, ``share``, ``max_abs_err``, ``bitwise``."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    rng = np.random.default_rng(0)
    A_np = rng.standard_normal((nblk, nb, nb)).astype(np.float32)
    x_np = rng.standard_normal((nblk, nb)).astype(np.float32)
    A = torch.as_tensor(A_np, device=device)
    x = torch.as_tensor(x_np, device=device)
    nbytes = A.numel() * 4
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"device: {name}  nblk={nblk} nb={nb}", flush=True)
    print(f"table: {nbytes / 1e6:.1f} MB, bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s", flush=True)
    timer = Timer() if on_card else None
    want = bm.block_mv_plain(A, x)
    ref = bm.block_mv(A, x)
    rows = []
    for label, kernel, apply in variants(A):
        y = apply(x)
        if on_card:
            torch.cuda.synchronize()
        err = float((y - want).abs().max())
        if not (bool(torch.isfinite(y).all()) and err <= TOL):
            raise RuntimeError(f"{label}: max abs error {err:.3e} against the "
                               f"plain version exceeds {TOL:.0e}")
        row = {"label": label, "kernel": kernel, "ms": None, "gbps": None,
               "share": None, "max_abs_err": err,
               "bitwise": bool(torch.equal(y, ref))}
        timing = "not measured (no card)"
        if on_card:
            ms = timer(lambda: apply(x))
            row.update(ms=ms, gbps=nbytes / ms / 1e6,
                       share=nbytes / HBM_BYTES_PER_S * 1e3 / ms)
            timing = (f"{ms:7.4f} ms  {row['gbps']:7.1f} GB/s  "
                      f"{row['share']:5.3f} of bound")
        print(f"  {label:28s} {timing}  max|err| {err:.2e}"
              f"{'  bitwise = block_mv' if row['bitwise'] else ''}",
              flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))

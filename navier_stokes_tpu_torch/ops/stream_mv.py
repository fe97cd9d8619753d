"""Hand-written CUDA table-stream variants of the batched block matvec, with
their plain PyTorch versions.  Counterpart of the Pallas kernels of
``scripts/microbench_dma.py`` and ``scripts/microbench_apply2.py``: the study
of HOW the table bytes of ``block_mv`` are best brought on chip.

All compute y[b, i] = sum_j A[b, i, j] x[b, j]; what varies is the copy.

* :func:`block_mv_rows` replaces ``_mv_kernel`` via ``make_bmv``
  (microbench_dma.py:92, call :101): ``block_mv``'s kernel with the CTA's
  row count given by the caller, up to what opt-in shared memory holds.
* :func:`make_bmv_splitk_seq` replaces ``make_bmv_splitk_seq`` /
  ``_mv_kernel_splitk_seq`` (:119, call :139): the table packed into k
  consecutive-tile sub-tables, streamed by ONE
  :func:`~navier_stokes_tpu_torch.ops.block_mv.block_mv_splitk` launch.
* :func:`block_mv_mega` replaces ``make_bmv_mega`` (:170, call :190): one
  CTA takes k tiles as one contiguous stretch in ONE 1-D bulk asynchronous
  copy (``cp.async.bulk`` completing on an ``mbarrier``).
* :func:`block_mv_ring` replaces ``make_bmv_manual`` (:212, call :253): a
  persistent grid walks the tiles with a ring of ``nbuf`` shared-memory
  stages, each filled by a bulk asynchronous copy with its own
  ``mbarrier``; the copy of tile i + nbuf starts when tile i is consumed.
* :func:`block_mv_soa` replaces ``mv_kernel`` (microbench_apply2.py:123,
  call :129): y[i, e] = sum_j A2[i, j, e] u[j, e] on the structure-of-arrays
  table with the element on the fastest axis, one thread per element.

The kernels live in ``csrc/stream_mv.cu`` (split-k: ``csrc/block_mv.cu``).
Each is bound by the table stream: table bytes / 3.35 TB/s.  Each keeps
``block_mv``'s per-row accumulation order, so results are bitwise equal to
``block_mv``'s on the same table.

Wrappers check device, dtype, shape, contiguity and alignment.  A wrapper
takes its plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.  Launches are counted in
``ops.block_mv.LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .block_mv import (
    LAUNCHES,
    _check_table,
    _check_vec,
    _device_kind,
    _launch,
    _stream,
    block_mv_plain,
    block_mv_splitk,
    build_library,
    pack_splitk,
)

__all__ = ["load_library", "SMEM_OPT_IN", "rows_smem_bytes", "block_mv_rows",
           "make_bmv_splitk_seq", "block_mv_mega", "block_mv_ring",
           "block_mv_soa", "block_mv_soa_plain", "pack_soa",
           "face_apply_soa", "SOA_MAX_NB", "MAX_STAGES"]

SMEM_OPT_IN = 232448  # bytes of shared memory one CTA may opt in to (227 KB)
_HEADER = 128  # bytes ahead of the stages (csrc kHeader: the mbarriers)
MAX_STAGES = 8  # csrc kMaxStages
SOA_MAX_NB = 64  # csrc kSoaMaxNb
_lib = None


def load_library():
    """The compiled kernels as a ctypes library (built at first use)."""
    global _lib
    if _lib is None:
        path, _ = build_library(name="stream_mv")
        lib = ctypes.CDLL(str(path))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.nstt_block_mv_rows_f32.argtypes = [p, p, p, i64, i32, i32, i32, p]
        lib.nstt_block_mv_mega_f32.argtypes = [p, p, p, i64, i32, i32, i32, p]
        lib.nstt_block_mv_ring_f32.argtypes = [p, p, p, i64, i32, i32, i32,
                                               i32, p]
        lib.nstt_block_mv_soa_f32.argtypes = [p, p, p, i32, i64, p]
        for fn in (lib.nstt_block_mv_rows_f32, lib.nstt_block_mv_mega_f32,
                   lib.nstt_block_mv_ring_f32, lib.nstt_block_mv_soa_f32):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_f32(A, x, name):
    _check_table(A, f"{name} table")
    _check_vec(x, A, f"{name} x")


def _empty_y(A):
    return torch.empty(A.shape[:2], dtype=torch.float32, device=A.device)


# -- row 9: the CTA's row count as an argument ---------------------------------


def rows_smem_bytes(rows: int, m: int, k: int) -> int:
    """Shared memory of one :func:`block_mv_rows` CTA: ``rows`` table rows
    at the odd stride ``k | 1`` and the x of the blocks they touch."""
    return 4 * (rows * (k | 1) + ((rows - 1) // m + 2) * k)


def block_mv_rows(A: torch.Tensor, x: torch.Tensor,
                  rows: int = 0) -> torch.Tensor:
    """y (nblk, m) f32 = A (nblk, m, k) x (nblk, k) with ``rows`` output rows
    per CTA; ``rows=0`` keeps :func:`block_mv`'s choice (what fits 48 KB).

    Replaces ``_mv_kernel`` as ``make_bmv`` calls it at a given tile
    (scripts/microbench_dma.py:92-116).  Bound by the table stream:
    nblk*m*k*4 bytes / 3.35 TB/s.  Raises when ``rows`` rows do not fit the
    227 KB of opt-in shared memory."""
    _check_f32(A, x, "block_mv_rows")
    nblk, m, k = A.shape
    if rows < 0 or (rows and rows_smem_bytes(rows, m, k) > SMEM_OPT_IN):
        raise ValueError(f"block_mv_rows: rows={rows} of {k} entries do not "
                         f"fit {SMEM_OPT_IN} bytes of shared memory")
    if _device_kind(A) == "cpu":
        return block_mv_plain(A, x)
    y = _empty_y(A)
    if y.numel() == 0:
        return y
    _launch(load_library().nstt_block_mv_rows_f32, A.data_ptr(), x.data_ptr(),
            y.data_ptr(), nblk, m, k, rows, _stream(A))
    LAUNCHES["block_mv_rows"] += 1
    return y


# -- row 10: k consecutive-tile operands in one launch ---------------------------


def make_bmv_splitk_seq(A: torch.Tensor, k: int, tile: int):
    """apply(x) for the table packed into ``k`` consecutive-tile sub-tables
    of ``tile``-block tiles (global tile i*k+j is tile i of sub-table j;
    :func:`pack_splitk`), all given to ONE ``block_mv_splitk`` launch, which
    writes the k outputs interleaved back in block order.

    Replaces ``make_bmv_splitk_seq`` (scripts/microbench_dma.py:126-163).
    ``apply.table`` is the list of sub-tables."""
    _check_table(A, "make_bmv_splitk_seq table")
    subs = pack_splitk(A, k, tile)

    def apply(x):
        return block_mv_splitk(subs, x, tile)

    apply.table = subs
    return apply


# -- rows 11 and 12: bulk asynchronous copies -------------------------------------


def _stage_bytes(rows: int, m: int, k: int) -> int:
    """One shared-memory stage of the bulk-copy kernels: ``rows`` table rows
    at stride ``k`` and the x of the blocks they touch."""
    return 4 * (rows * k + ((rows - 1) // m + 2) * k)


def _check_stretch(A, rows, stages, name):
    """The alignment rule of a bulk copy: every stretch of ``rows`` table
    rows starts on a 16-byte boundary, and ``stages`` of them fit."""
    nblk, m, k = A.shape
    if rows < 1:
        raise ValueError(f"{name}: rows={rows} must be positive")
    if (rows * k) % 4:
        raise ValueError(f"{name}: rows={rows} of {k} f32 entries are not a "
                         "multiple of 16 bytes; choose rows so that rows*k "
                         "is a multiple of 4")
    if _HEADER + stages * _stage_bytes(rows, m, k) > SMEM_OPT_IN:
        raise ValueError(f"{name}: {stages} x {rows} rows of {k} entries do "
                         f"not fit {SMEM_OPT_IN} bytes of shared memory")
    if A.device.type == "cuda" and A.data_ptr() % 16:
        raise ValueError(f"{name}: table not 16-byte aligned")


def block_mv_mega(A: torch.Tensor, x: torch.Tensor, k: int,
                  rows: int) -> torch.Tensor:
    """y = A x with one CTA per ``k`` tiles of ``rows`` output rows each,
    their table stretch fetched by ONE bulk asynchronous copy.

    Replaces ``make_bmv_mega`` (scripts/microbench_dma.py:170-209: k tiles
    as one larger block per grid step).  Bound by the table stream:
    nblk*m*kk*4 bytes / 3.35 TB/s.  ``k*rows`` rows of the table must be a
    multiple of 16 bytes and fit 227 KB."""
    _check_f32(A, x, "block_mv_mega")
    if k < 1 or rows < 1:
        raise ValueError(f"block_mv_mega: k={k} and rows={rows} must be "
                         "positive")
    _check_stretch(A, k * rows, 1, "block_mv_mega")
    if _device_kind(A) == "cpu":
        return block_mv_plain(A, x)
    y = _empty_y(A)
    if y.numel() == 0:
        return y
    nblk, m, kk = A.shape
    _launch(load_library().nstt_block_mv_mega_f32, A.data_ptr(), x.data_ptr(),
            y.data_ptr(), nblk, m, kk, k * rows, _stream(A))
    LAUNCHES["block_mv_mega"] += 1
    return y


def block_mv_ring(A: torch.Tensor, x: torch.Tensor, nbuf: int,
                  rows: int) -> torch.Tensor:
    """y = A x by a persistent grid whose CTAs keep ``nbuf`` bulk
    asynchronous copies of ``rows``-row tiles in flight (one ``mbarrier``
    per shared-memory stage).

    Replaces ``make_bmv_manual`` (scripts/microbench_dma.py:212-264: the
    table left in device memory, ``nbuf`` block copies started by hand, one
    loop over all tiles).  Bound by the table stream: nblk*m*k*4 bytes /
    3.35 TB/s.  A tile must be a multiple of 16 bytes, and ``nbuf`` of them
    must fit 227 KB."""
    _check_f32(A, x, "block_mv_ring")
    if not 1 <= nbuf <= MAX_STAGES:
        raise ValueError(f"block_mv_ring: nbuf={nbuf} outside 1..{MAX_STAGES}")
    _check_stretch(A, rows, nbuf, "block_mv_ring")
    if _device_kind(A) == "cpu":
        return block_mv_plain(A, x)
    y = _empty_y(A)
    if y.numel() == 0:
        return y
    nblk, m, k = A.shape
    _launch(load_library().nstt_block_mv_ring_f32, A.data_ptr(), x.data_ptr(),
            y.data_ptr(), nblk, m, k, rows, nbuf, _stream(A))
    LAUNCHES["block_mv_ring"] += 1
    return y


# -- row 13: the structure-of-arrays table -------------------------------------------


def block_mv_soa_plain(A2: torch.Tensor, uT: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`block_mv_soa`."""
    return torch.einsum("ije,je->ie", A2, uT)


def block_mv_soa(A2: torch.Tensor, uT: torch.Tensor) -> torch.Tensor:
    """yT (nb, ne_p) f32 = sum_j A2[:, j, :] * uT[j, :] for the
    structure-of-arrays table A2 (nb, nb, ne_p), element on the fastest axis.

    Replaces ``mv_kernel`` (scripts/microbench_apply2.py:123-141).  Bound by
    the table stream: nb*nb*ne_p*4 bytes / 3.35 TB/s.  Padding columns (zero
    in A2 and uT) come out zero.  The kernel takes nb <= 64."""
    if A2.dim() != 3 or A2.shape[0] != A2.shape[1]:
        raise ValueError("block_mv_soa: expected an (nb, nb, ne_p) table, got "
                         f"{tuple(A2.shape)}")
    nb, _, ne_p = A2.shape
    if A2.dtype != torch.float32 or uT.dtype != torch.float32:
        raise TypeError(f"block_mv_soa: expected float32, got {A2.dtype} and "
                        f"{uT.dtype}")
    if tuple(uT.shape) != (nb, ne_p):
        raise ValueError(f"block_mv_soa: expected vectors {(nb, ne_p)}, got "
                         f"{tuple(uT.shape)}")
    if uT.device != A2.device:
        raise ValueError(f"block_mv_soa: vectors on {uT.device}, table on "
                         f"{A2.device}")
    if not (A2.is_contiguous() and uT.is_contiguous()):
        raise ValueError("block_mv_soa: operands must be contiguous")
    if _device_kind(A2) == "cpu":
        return block_mv_soa_plain(A2, uT)
    if nb > SOA_MAX_NB:
        raise ValueError(f"block_mv_soa: the kernel takes nb <= {SOA_MAX_NB}, "
                         f"got {nb}")
    y = torch.empty_like(uT)
    if y.numel() == 0:
        return y
    _launch(load_library().nstt_block_mv_soa_f32, A2.data_ptr(),
            uT.data_ptr(), y.data_ptr(), nb, ne_p, _stream(A2))
    LAUNCHES["block_mv_soa"] += 1
    return y


def pack_soa(A_perm: np.ndarray, tile: int = 256, device=None) -> torch.Tensor:
    """(ne, nb, nb) face-major element blocks -> the f32 structure-of-arrays
    table (nb, nb, ne_p), the element count zero-padded to a multiple of
    ``tile`` (scripts/microbench_apply2.py:80-84)."""
    ne, nb, _ = A_perm.shape
    ne_p = -(-ne // tile) * tile
    A_pad = np.zeros((ne_p, nb, nb), np.float32)
    A_pad[:ne] = A_perm
    return torch.as_tensor(np.ascontiguousarray(A_pad.transpose(1, 2, 0)),
                           device=device)


def face_apply_soa(lay, A2: torch.Tensor, mv=block_mv_soa):
    """u -> A u through the face-block layout ``lay`` around the
    structure-of-arrays product ``mv`` (:func:`block_mv_soa`, or its plain
    version): split, gather to (ne, nb), zero-pad and transpose to
    (nb, ne_p), product, transpose back, two-sibling gather, join
    (scripts/microbench_apply2.py:143-152)."""
    ne, ne_p = lay.ne, A2.shape[2]

    def apply(u):
        uF, ui = lay.split(u)
        ue = lay.gather_elem(uF, ui)
        ueT = torch.cat([ue, ue.new_zeros((ne_p - ne, lay.nb))]).T.contiguous()
        ye = mv(A2, ueT).T[:ne]
        yF, yi = lay.scatter_elem(ye)
        return lay.join(yF, yi)

    return apply

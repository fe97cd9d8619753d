"""Hand-written CUDA block matvecs of the flagship solve, with their plain
PyTorch versions.  Counterpart of ``navier_stokes_tpu/ops/pallas_mv.py``.

Four kernels live in ``csrc/block_mv.cu``, all of the form
y[b, i] = sum_j A[b, i, j] x[b, j] over (nblk, m, k) row-major tables:

* :func:`block_mv` replaces ``_mv_kernel`` (pallas_mv.py:118): f32 or
  bf16-STORED tables, f32 arithmetic, any m x k.  Every preconditioner table
  apply goes through it on the card (harmonic extension and its transpose,
  interior solve, coarse face transfer, edge-star inverses).
* :func:`block_mv2` replaces ``_mv2_kernel`` (pallas_mv.py:124): the split
  operator (A_hi + A_lo) x streamed in one pass sharing x — the phase-1
  f32 operators A32, B32 and BT32.
* :func:`block_mv_ds` replaces ``_mv_ds_kernel`` (pallas_mv.py:129): the
  three f32 products A_hi x_hi, A_hi x_lo, A_lo x_hi of the plain
  double-single apply from one pass over both tables
  (``FaceBlockLayout.elem_apply_ds`` / ``rect_apply_ds``).
* :func:`block_mv_comp` replaces ``_mv_comp_kernel`` (pallas_mv.py:166):
  the compensated double-single product (two_prod / two_sum), whose
  y_hi + y_lo carries ~2^-45 of sum_j |a_ij x_j| — the phase-2 operators
  and every per-pass residual.

Three more run the same functions over a table cut into k
consecutive-tile sub-tables (:func:`pack_splitk`), all k given to ONE
launch as separate operands, with every sub-table's loads issued before
the arithmetic:

* :func:`block_mv_splitk` replaces ``_mv_kernel_splitk``
  (pallas_mv.py:305);
* :func:`block_mv2_splitk` replaces ``_mv2_kernel_splitk``
  (pallas_mv.py:358);
* :func:`block_mv_comp_splitk` replaces ``_mv_comp_kernel_splitk``
  (pallas_mv.py:397).

They keep their unsplit kernel's per-row accumulation order, so on the
same table a split-k result is bitwise equal to the unsplit one.

Each is bound by device memory bandwidth: it reads its table bytes once
(plus the small x and y), against 2 (about 15 for the compensated kernel)
flops per table element.  At the maxh=0.09 shapes the phase-1 A32 split
table is 2 x 7740 x 54 x 54 x 4 B = 181 MB, i.e. 54 us at 3.35 TB/s.

Wrappers check device, dtype, shape and contiguity.  A wrapper takes its
plain version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  ``LAUNCHES`` counts kernel launches per wrapper (those of
``ops/local_mv.py`` and ``ops/stream_mv.py`` too).

Each source under ``csrc/`` is compiled from the repository at first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3`` into its own library
under ``build/`` at the repository root (a temporary name renamed into
place, so a half-written library is never loaded) and bound with ctypes;
:func:`build_all` compiles all of them at once, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "LAUNCHES", "reset_launches", "SOURCES", "build_library", "build_all",
    "load_library", "block_mv", "block_mv_plain", "block_mv2",
    "block_mv2_plain", "block_mv_ds", "block_mv_ds_plain", "block_mv_comp",
    "block_mv_comp_plain", "split_f64", "make_table_apply", "MAX_SPLIT",
    "pack_splitk", "block_mv_splitk", "block_mv_splitk_plain",
    "block_mv2_splitk", "block_mv2_splitk_plain", "block_mv_comp_splitk",
    "block_mv_comp_splitk_plain",
]

LAUNCHES = {"block_mv": 0, "block_mv2": 0, "block_mv_comp": 0,
            "block_mv_splitk": 0, "block_mv2_splitk": 0,
            "block_mv_comp_splitk": 0, "block_mv_ds": 0,
            "batched_local_matvec": 0, "block_mv_rows": 0,
            "block_mv_mega": 0, "block_mv_ring": 0, "block_mv_soa": 0}
MAX_SPLIT = 8  # sub-tables one split-k launch takes (csrc kMaxSplit)

_PKG = Path(__file__).resolve().parent.parent
# csrc/<name>.cu -> build/lib<name>_*.so
SOURCES = ("block_mv", "local_mv", "stream_mv")
_BUILD_DIR = _PKG.parent / "build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
_lib = None


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_library(verbose: bool = False,
                  name: str = "block_mv") -> tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags is already built.  Returns (path, seconds spent compiling)."""
    src_path = _PKG / "csrc" / f"{name}.cu"
    src = src_path.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"lib{name}_{tag}.so"
    if out.exists():
        return out, 0.0
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(src_path)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr, flush=True)
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


def build_all(verbose: bool = False) -> dict:
    """Compile every source of :data:`SOURCES` at once, one nvcc process
    each.  Returns {name: (path, seconds spent compiling)}."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        futs = {name: pool.submit(build_library, verbose, name)
                for name in SOURCES}
        return {name: fut.result() for name, fut in futs.items()}


def load_library():
    """The compiled kernels as a ctypes library (built at first use)."""
    global _lib
    if _lib is None:
        path, _ = build_library()
        lib = ctypes.CDLL(str(path))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.nstt_block_mv_f32.argtypes = [p, p, p, i64, i32, i32, p]
        lib.nstt_block_mv_bf16.argtypes = [p, p, p, i64, i32, i32, p]
        lib.nstt_block_mv2_f32.argtypes = [p, p, p, p, i64, i32, i32, p]
        lib.nstt_block_mv_comp_f32.argtypes = [p, p, p, p, p, p, i64, i32,
                                               i32, p]
        lib.nstt_block_mv_ds_f32.argtypes = [p, p, p, p, p, p, p, i64, i32,
                                             i32, p]
        # split-k: (pointer array, k, ..., rows per sub-table, tile, stream)
        pp = ctypes.POINTER(ctypes.c_void_p)
        lib.nstt_block_mv_splitk_f32.argtypes = [pp, i32, p, p, i64, i32,
                                                 i32, i64, i32, p]
        lib.nstt_block_mv_splitk_bf16.argtypes = [pp, i32, p, p, i64, i32,
                                                  i32, i64, i32, p]
        lib.nstt_block_mv2_splitk_f32.argtypes = [pp, pp, i32, p, p, i64, i32,
                                                  i32, i64, i32, p]
        lib.nstt_block_mv_comp_splitk_f32.argtypes = [pp, pp, i32, p, p, p, p,
                                                      i64, i32, i32, i64, i32,
                                                      p]
        for fn in (lib.nstt_block_mv_f32, lib.nstt_block_mv_bf16,
                   lib.nstt_block_mv2_f32, lib.nstt_block_mv_comp_f32,
                   lib.nstt_block_mv_ds_f32, lib.nstt_block_mv_splitk_f32, lib.nstt_block_mv_splitk_bf16,
                   lib.nstt_block_mv2_splitk_f32,
                   lib.nstt_block_mv_comp_splitk_f32):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_table(A, name, dtypes=(torch.float32,)):
    if A.dim() != 3:
        raise ValueError(f"{name}: expected (nblk, m, k), got {tuple(A.shape)}")
    if A.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {A.dtype} not in {dtypes}")
    if not A.is_contiguous():
        raise ValueError(f"{name}: table must be contiguous")


def _check_vec(x, A, name):
    nblk, _, k = A.shape
    want = torch.float64 if A.dtype == torch.float64 else torch.float32
    if x.dtype != want:
        raise TypeError(f"{name}: expected {want}, got {x.dtype}")
    if tuple(x.shape) != (nblk, k):
        raise ValueError(f"{name}: expected {(nblk, k)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: vector must be contiguous")
    if x.device != A.device:
        raise ValueError(f"{name}: on {x.device}, table on {A.device}")


def _device_kind(A) -> str:
    kind = A.device.type
    if kind not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {A.device}")
    return kind


def _launch(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel launch failed with error {rc}")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# -- kernel 1: y = A x ----------------------------------------------------


def block_mv_plain(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`block_mv` (arithmetic in x's dtype:
    f32, or f64 for an f64 table)."""
    return torch.einsum("bmk,bk->bm", A.to(x.dtype), x)


def block_mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y (nblk, m) f32 = A (nblk, m, k) x (nblk, k), A f32 or bf16-stored.

    Replaces ``_mv_kernel`` (navier_stokes_tpu/ops/pallas_mv.py:118).  Bound
    by the table stream: nblk*m*k*itemsize bytes / 3.35 TB/s.  An f64 table
    with an f64 x is taken on the CPU only (the host-math tests of the
    preconditioner in f64); the kernel raises on it."""
    _check_table(A, "block_mv table",
                 (torch.float32, torch.bfloat16, torch.float64))
    _check_vec(x, A, "block_mv x")
    if _device_kind(A) == "cpu":
        return block_mv_plain(A, x)
    if A.dtype == torch.float64:
        raise TypeError("block_mv: the kernel takes f32 or bf16 tables")
    nblk, m, k = A.shape
    y = torch.empty((nblk, m), dtype=torch.float32, device=A.device)
    if y.numel() == 0:
        return y
    lib = load_library()
    fn = (lib.nstt_block_mv_f32 if A.dtype == torch.float32
          else lib.nstt_block_mv_bf16)
    _launch(fn, A.data_ptr(), x.data_ptr(), y.data_ptr(), nblk, m, k,
            _stream(A))
    LAUNCHES["block_mv"] += 1
    return y


# -- kernel 2: y = (A_hi + A_lo) x ----------------------------------------


def block_mv2_plain(A_hi, A_lo, x):
    """Plain PyTorch version of :func:`block_mv2`."""
    return (torch.einsum("bmk,bk->bm", A_hi, x)
            + torch.einsum("bmk,bk->bm", A_lo, x))


def block_mv2(A_hi: torch.Tensor, A_lo: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """y = (A_hi x) + (A_lo x) streaming both f32 tables in one pass.

    Replaces ``_mv2_kernel`` (navier_stokes_tpu/ops/pallas_mv.py:124).
    Bound by the two table streams: 2*nblk*m*k*4 bytes / 3.35 TB/s."""
    _check_table(A_hi, "block_mv2 A_hi")
    _check_table(A_lo, "block_mv2 A_lo")
    if A_lo.shape != A_hi.shape or A_lo.device != A_hi.device:
        raise ValueError("block_mv2: A_hi and A_lo differ in shape or device")
    _check_vec(x, A_hi, "block_mv2 x")
    if _device_kind(A_hi) == "cpu":
        return block_mv2_plain(A_hi, A_lo, x)
    nblk, m, k = A_hi.shape
    y = torch.empty((nblk, m), dtype=torch.float32, device=A_hi.device)
    if y.numel() == 0:
        return y
    _launch(load_library().nstt_block_mv2_f32, A_hi.data_ptr(), A_lo.data_ptr(),
            x.data_ptr(), y.data_ptr(), nblk, m, k, _stream(A_hi))
    LAUNCHES["block_mv2"] += 1
    return y


# -- kernel 3: the three products of the plain double-single apply ---------


def block_mv_ds_plain(A_hi, A_lo, x_hi, x_lo):
    """Plain PyTorch version of :func:`block_mv_ds`."""
    return (torch.einsum("bmk,bk->bm", A_hi, x_hi),
            torch.einsum("bmk,bk->bm", A_hi, x_lo),
            torch.einsum("bmk,bk->bm", A_lo, x_hi))


def block_mv_ds(A_hi, A_lo, x_hi, x_lo):
    """Double-single products (A_hi x_hi, A_hi x_lo, A_lo x_hi), three f32
    (nblk, m) outputs from ONE pass over both f32 tables, any m x k.

    Replaces ``_mv_ds_kernel`` (navier_stokes_tpu/ops/pallas_mv.py:129,
    ``tiled_bmv_ds``).  Bound by the two table streams: 2*nblk*m*k*4
    bytes / 3.35 TB/s.  Summed in f64 the three approximate
    (A_hi + A_lo)(x_hi + x_lo) with plain f32 accumulation error: row
    cancellation floors the apply near 1e-6, which is why the solve's
    phase 2 runs on :func:`block_mv_comp` instead."""
    _check_table(A_hi, "block_mv_ds A_hi")
    _check_table(A_lo, "block_mv_ds A_lo")
    if A_lo.shape != A_hi.shape or A_lo.device != A_hi.device:
        raise ValueError("block_mv_ds: A_hi and A_lo differ")
    _check_vec(x_hi, A_hi, "block_mv_ds x_hi")
    _check_vec(x_lo, A_hi, "block_mv_ds x_lo")
    if _device_kind(A_hi) == "cpu":
        return block_mv_ds_plain(A_hi, A_lo, x_hi, x_lo)
    nblk, m, k = A_hi.shape
    hh = torch.empty((nblk, m), dtype=torch.float32, device=A_hi.device)
    hl, lh = torch.empty_like(hh), torch.empty_like(hh)
    if hh.numel() == 0:
        return hh, hl, lh
    _launch(load_library().nstt_block_mv_ds_f32, A_hi.data_ptr(),
            A_lo.data_ptr(), x_hi.data_ptr(), x_lo.data_ptr(), hh.data_ptr(),
            hl.data_ptr(), lh.data_ptr(), nblk, m, k, _stream(A_hi))
    LAUNCHES["block_mv_ds"] += 1
    return hh, hl, lh


# -- kernel 4: compensated double-single product ---------------------------

_SPLIT = 4097.0  # Dekker split constant for f32: 2^12 + 1


def _two_prod(a, b):
    """(p, err) with p + err == a*b exactly (Dekker splitting).  Eager
    PyTorch rounds every operation, so no contraction can spoil it."""
    p = a * b
    ca = a * _SPLIT
    a1 = ca - (ca - a)
    a2 = a - a1
    cb = b * _SPLIT
    b1 = cb - (cb - b)
    b2 = b - b1
    err = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, err


def block_mv_comp_plain(A_hi, A_lo, x_hi, x_lo):
    """Plain PyTorch version of :func:`block_mv_comp`: the same two_prod /
    two_sum recurrence, the same rounded operations on every entry.  The
    products are formed for all columns at once; the two_sum chain runs
    column by column, as the kernel's does."""
    xh = x_hi[:, None, :]
    p, err = _two_prod(A_hi, xh)
    small = (A_hi * x_lo[:, None, :] + A_lo * xh) + err
    s = torch.zeros(A_hi.shape[:2], dtype=torch.float32, device=A_hi.device)
    sl = torch.zeros_like(s)
    for j in range(A_hi.shape[2]):
        pj = p[:, :, j]
        t = s + pj
        bb = t - s
        e = (s - (t - bb)) + (pj - bb)
        s = t
        sl = sl + (e + small[:, :, j])
    return s, sl


def block_mv_comp(A_hi, A_lo, x_hi, x_lo):
    """Compensated double-single product: (y_hi, y_lo) f32 with
    y_hi + y_lo ~ (A_hi + A_lo)(x_hi + x_lo) to ~2^-45 of sum_j |a_ij x_j|.

    Replaces ``_mv_comp_kernel`` (navier_stokes_tpu/ops/pallas_mv.py:166).
    Bound by the two table streams: 2*nblk*m*k*4 bytes / 3.35 TB/s."""
    _check_table(A_hi, "block_mv_comp A_hi")
    _check_table(A_lo, "block_mv_comp A_lo")
    if A_lo.shape != A_hi.shape or A_lo.device != A_hi.device:
        raise ValueError("block_mv_comp: A_hi and A_lo differ")
    _check_vec(x_hi, A_hi, "block_mv_comp x_hi")
    _check_vec(x_lo, A_hi, "block_mv_comp x_lo")
    if _device_kind(A_hi) == "cpu":
        return block_mv_comp_plain(A_hi, A_lo, x_hi, x_lo)
    nblk, m, k = A_hi.shape
    y_hi = torch.empty((nblk, m), dtype=torch.float32, device=A_hi.device)
    y_lo = torch.empty_like(y_hi)
    if y_hi.numel() == 0:
        return y_hi, y_lo
    _launch(load_library().nstt_block_mv_comp_f32, A_hi.data_ptr(),
            A_lo.data_ptr(), x_hi.data_ptr(), x_lo.data_ptr(),
            y_hi.data_ptr(), y_lo.data_ptr(), nblk, m, k, _stream(A_hi))
    LAUNCHES["block_mv_comp"] += 1
    return y_hi, y_lo


def split_f64(x: torch.Tensor):
    """f64 tensor -> contiguous f32 (hi, lo) with hi + lo ~ x to ~2^-48."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return hi.contiguous(), lo.contiguous()


# -- kernels 5-7: split-k over consecutive-tile sub-tables -------------------


def pack_splitk(A: torch.Tensor, k: int, tile: int) -> list:
    """(nblk, m, kk) table -> k sub-tables of (ng*tile, m, kk) each: global
    tile i*k+j goes to sub-table j, position i, with the block count
    zero-padded to ng*k*tile (``_pack_splitk``, pallas_mv.py:315-324, in
    the natural layout).  Every sub-table is a fresh allocation, so it is
    16-byte aligned as the kernels require."""
    if not 1 <= k <= MAX_SPLIT:
        raise ValueError(f"split_k={k} outside 1..{MAX_SPLIT}")
    if tile < 1:
        raise ValueError(f"tile={tile} must be positive")
    nblk, m, kk = A.shape
    ntile = -(-nblk // tile)
    ng = -(-ntile // k)
    pad = ng * k * tile - nblk
    if pad:
        A = torch.cat([A, A.new_zeros((pad, m, kk))])
    grp = A.reshape(ng, k, tile, m, kk)
    return [grp[:, j].reshape(ng * tile, m, kk).clone(
        memory_format=torch.contiguous_format) for j in range(k)]


def _check_subs(subs, name, dtypes=(torch.float32,)):
    subs = list(subs)
    if not 1 <= len(subs) <= MAX_SPLIT:
        raise ValueError(f"{name}: {len(subs)} sub-tables, not 1..{MAX_SPLIT}")
    for A in subs:
        _check_table(A, name, dtypes)
        if (A.shape, A.dtype, A.device) != (subs[0].shape, subs[0].dtype,
                                            subs[0].device):
            raise ValueError(f"{name}: sub-tables differ in shape, dtype or "
                             "device")
        if A.device.type == "cuda" and A.data_ptr() % 16:
            raise ValueError(f"{name}: sub-table not 16-byte aligned")
    return subs


def _check_split_x(x, subs, tile, name):
    nsub, _, kk = subs[0].shape
    if nsub % tile:
        raise ValueError(f"{name}: {nsub} blocks per sub-table, not a "
                         f"multiple of tile={tile}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != kk or x.shape[0] > len(subs) * nsub:
        raise ValueError(f"{name}: x of shape {tuple(x.shape)} does not fit "
                         f"{len(subs)} sub-tables of {tuple(subs[0].shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: vector must be contiguous")
    if x.device != subs[0].device:
        raise ValueError(f"{name}: on {x.device}, tables on {subs[0].device}")


def _split_x(x, k, tile, nsub):
    """x (nblk, kk) -> k per-sub-table slices (nsub, kk) of the padded x."""
    nblk, kk = x.shape
    xp = torch.cat([x, x.new_zeros((k * nsub - nblk, kk))])
    grp = xp.reshape(nsub // tile, k, tile, kk)
    return [grp[:, j].reshape(nsub, kk) for j in range(k)]


def _interleave(ys, tile, nblk):
    """Per-sub-table results (nsub, m) -> (nblk, m) in global block order."""
    nsub, m = ys[0].shape
    y = torch.stack([t.reshape(nsub // tile, tile, m) for t in ys], dim=1)
    return y.reshape(-1, m)[:nblk]


def _ptrs(subs):
    return (ctypes.c_void_p * MAX_SPLIT)(*[t.data_ptr() for t in subs])


def block_mv_splitk_plain(subs, x, tile: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`block_mv_splitk`: per sub-table,
    tiles interleaved back."""
    xs = _split_x(x, len(subs), tile, subs[0].shape[0])
    return _interleave([block_mv_plain(A, xj) for A, xj in zip(subs, xs)],
                       tile, x.shape[0])


def block_mv_splitk(subs, x: torch.Tensor, tile: int) -> torch.Tensor:
    """y (nblk, m) f32 = A x for a table given as k sub-tables
    (:func:`pack_splitk`), f32 or bf16-stored, in ONE launch.

    Replaces ``_mv_kernel_splitk`` (navier_stokes_tpu/ops/pallas_mv.py:305).
    Bound by the table stream of the real blocks: nblk*m*kk*itemsize
    bytes / 3.35 TB/s (the kernel does not load the zero pad).  Bitwise
    equal to :func:`block_mv` on the unsplit table."""
    subs = _check_subs(subs, "block_mv_splitk tables",
                       (torch.float32, torch.bfloat16))
    _check_split_x(x, subs, tile, "block_mv_splitk x")
    if _device_kind(subs[0]) == "cpu":
        return block_mv_splitk_plain(subs, x, tile)
    nsub, m, kk = subs[0].shape
    y = torch.empty((x.shape[0], m), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = load_library()
    fn = (lib.nstt_block_mv_splitk_f32 if subs[0].dtype == torch.float32
          else lib.nstt_block_mv_splitk_bf16)
    _launch(fn, _ptrs(subs), len(subs), x.data_ptr(), y.data_ptr(),
            x.shape[0], m, kk, nsub, tile, _stream(x))
    LAUNCHES["block_mv_splitk"] += 1
    return y


def block_mv2_splitk_plain(his, los, x, tile: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`block_mv2_splitk`."""
    xs = _split_x(x, len(his), tile, his[0].shape[0])
    return _interleave([block_mv2_plain(h, lo, xj)
                        for h, lo, xj in zip(his, los, xs)], tile, x.shape[0])


def _check_pair(his, los, name):
    his = _check_subs(his, f"{name} A_hi")
    los = _check_subs(los, f"{name} A_lo")
    if len(his) != len(los) or (his[0].shape, his[0].device) != (
            los[0].shape, los[0].device):
        raise ValueError(f"{name}: hi and lo sub-tables differ")
    return his, los


def block_mv2_splitk(his, los, x: torch.Tensor, tile: int) -> torch.Tensor:
    """y = (A_hi x) + (A_lo x) for the split pair given as k hi and k lo
    sub-tables, all streamed by ONE launch.

    Replaces ``_mv2_kernel_splitk`` (navier_stokes_tpu/ops/pallas_mv.py:358).
    Bound: 2*nblk*m*kk*4 bytes / 3.35 TB/s (the zero pad is not loaded).
    Bitwise equal to :func:`block_mv2` on the unsplit pair."""
    his, los = _check_pair(his, los, "block_mv2_splitk")
    _check_split_x(x, his, tile, "block_mv2_splitk x")
    if _device_kind(his[0]) == "cpu":
        return block_mv2_splitk_plain(his, los, x, tile)
    nsub, m, kk = his[0].shape
    y = torch.empty((x.shape[0], m), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    _launch(load_library().nstt_block_mv2_splitk_f32, _ptrs(his), _ptrs(los),
            len(his), x.data_ptr(), y.data_ptr(), x.shape[0], m, kk, nsub,
            tile, _stream(x))
    LAUNCHES["block_mv2_splitk"] += 1
    return y


def block_mv_comp_splitk_plain(his, los, x_hi, x_lo, tile: int):
    """Plain PyTorch version of :func:`block_mv_comp_splitk`: the same
    rounded operations on every entry as :func:`block_mv_comp_plain`, so
    bitwise equal to it on the unsplit pair."""
    k, nsub = len(his), his[0].shape[0]
    parts = [block_mv_comp_plain(h, lo, xh, xl) for h, lo, xh, xl in zip(
        his, los, _split_x(x_hi, k, tile, nsub),
        _split_x(x_lo, k, tile, nsub))]
    return (_interleave([p[0] for p in parts], tile, x_hi.shape[0]),
            _interleave([p[1] for p in parts], tile, x_hi.shape[0]))


def block_mv_comp_splitk(his, los, x_hi, x_lo, tile: int):
    """Compensated double-single product over k hi and k lo sub-tables in
    ONE launch: (y_hi, y_lo) as :func:`block_mv_comp`.

    Replaces ``_mv_comp_kernel_splitk``
    (navier_stokes_tpu/ops/pallas_mv.py:397).  Bound: 2*nblk*m*kk*4
    bytes / 3.35 TB/s (the zero pad is not loaded).  Bitwise equal to
    :func:`block_mv_comp` on the unsplit pair."""
    his, los = _check_pair(his, los, "block_mv_comp_splitk")
    _check_split_x(x_hi, his, tile, "block_mv_comp_splitk x_hi")
    _check_split_x(x_lo, his, tile, "block_mv_comp_splitk x_lo")
    if x_hi.shape != x_lo.shape:
        raise ValueError("block_mv_comp_splitk: x_hi and x_lo differ")
    if _device_kind(his[0]) == "cpu":
        return block_mv_comp_splitk_plain(his, los, x_hi, x_lo, tile)
    nsub, m, kk = his[0].shape
    y_hi = torch.empty((x_hi.shape[0], m), dtype=torch.float32,
                       device=x_hi.device)
    y_lo = torch.empty_like(y_hi)
    if y_hi.numel() == 0:
        return y_hi, y_lo
    _launch(load_library().nstt_block_mv_comp_splitk_f32, _ptrs(his),
            _ptrs(los), len(his), x_hi.data_ptr(), x_lo.data_ptr(),
            y_hi.data_ptr(), y_lo.data_ptr(), x_hi.shape[0], m, kk, nsub,
            tile, _stream(x_hi))
    LAUNCHES["block_mv_comp_splitk"] += 1
    return y_hi, y_lo


# -- table applies ----------------------------------------------------------

TILE = 256  # blocks per tile of the split-k grouping (pallas_mv.py:460)
TILE_COMP = 128  # ... of the compensated pressure applies (faceblock.py:373)


def make_table_apply(A, store_dtype=torch.float32, device=None,
                     split_k: int = 1, tile: int = TILE,
                     compute_dtype=torch.float32):
    """Batched block matvec fn (nblk, k) f32 -> (nblk, m) f32 for an
    (nblk, m, k) table (numpy or tensor), stored in ``store_dtype`` (f32 or
    bf16; arithmetic stays f32).  Counterpart of
    ``navier_stokes_tpu.ops.pallas_mv.make_table_apply``: every table apply
    goes through :func:`block_mv`, whatever the batch size, or with
    ``split_k`` > 1 through :func:`block_mv_splitk` over ``split_k``
    sub-tables of ``tile``-block tiles.  ``apply.table`` is the stored
    table: one tensor, or the list of sub-tables.

    ``compute_dtype=torch.float64`` (CPU only, as the JAX package's f64
    model preconditioner): the table rounded to ``store_dtype`` is held
    exactly in f64 and applied to f64 vectors."""
    if isinstance(A, np.ndarray):
        A = torch.from_numpy(np.ascontiguousarray(A))
    if device is None:
        device = A.device
    table = A.to(device=device, dtype=store_dtype).contiguous()
    if compute_dtype == torch.float64:
        if split_k > 1:
            raise ValueError("split-k tables are applied in f32")
        table = table.to(torch.float64)
    if split_k > 1:
        subs = pack_splitk(table, split_k, tile)
        del table

        def apply(x):
            return block_mv_splitk(subs, x.contiguous(), tile)

        apply.table = subs
        return apply

    def apply(x):
        return block_mv(table, x.contiguous())

    apply.table = table
    return apply

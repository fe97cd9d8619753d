"""Hand-written CUDA block matvecs of the flagship solve, with their plain
PyTorch versions.  Counterpart of ``navier_stokes_tpu/ops/pallas_mv.py``.

Three kernels live in ``csrc/block_mv.cu``, all of the form
y[b, i] = sum_j A[b, i, j] x[b, j] over (nblk, m, k) row-major tables:

* :func:`block_mv` replaces ``_mv_kernel`` (pallas_mv.py:118): f32 or
  bf16-STORED tables, f32 arithmetic, any m x k.  Every preconditioner table
  apply goes through it on the card (harmonic extension and its transpose,
  interior solve, coarse face transfer, edge-star inverses).
* :func:`block_mv2` replaces ``_mv2_kernel`` (pallas_mv.py:124): the split
  operator (A_hi + A_lo) x streamed in one pass sharing x — the phase-1
  f32 operators A32, B32 and BT32.
* :func:`block_mv_comp` replaces ``_mv_comp_kernel`` (pallas_mv.py:166):
  the compensated double-single product (two_prod / two_sum), whose
  y_hi + y_lo carries ~2^-45 of sum_j |a_ij x_j| — the phase-2 operators
  and every per-pass residual.

Each is bound by device memory bandwidth: it reads its table bytes once
(plus the small x and y), against 2 (about 15 for the compensated kernel)
flops per table element.  At the maxh=0.09 shapes the phase-1 A32 split
table is 2 x 7740 x 54 x 54 x 4 B = 181 MB, i.e. 54 us at 3.35 TB/s.

Wrappers check device, dtype, shape and contiguity.  A wrapper takes its
plain version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  ``LAUNCHES`` counts kernel launches per wrapper.

The library is compiled from the repository's source at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3`` into ``build/`` at the
repository root (a temporary name renamed into place, so a half-written
library is never loaded) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "LAUNCHES", "reset_launches", "build_library", "load_library", "block_mv",
    "block_mv_plain", "block_mv2", "block_mv2_plain", "block_mv_comp",
    "block_mv_comp_plain", "split_f64", "make_table_apply",
]

LAUNCHES = {"block_mv": 0, "block_mv2": 0, "block_mv_comp": 0}

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "block_mv.cu"
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


def build_library(verbose: bool = False) -> tuple[Path, float]:
    """Compile ``csrc/block_mv.cu`` unless a library of the same source and
    flags is already built.  Returns (path, seconds spent compiling)."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libblock_mv_{tag}.so"
    if out.exists():
        return out, 0.0
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SRC)]
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
        for fn in (lib.nstt_block_mv_f32, lib.nstt_block_mv_bf16,
                   lib.nstt_block_mv2_f32, lib.nstt_block_mv_comp_f32):
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
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
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
    """Plain PyTorch version of :func:`block_mv` (f32 arithmetic)."""
    return torch.einsum("bmk,bk->bm", A.to(torch.float32), x)


def block_mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y (nblk, m) f32 = A (nblk, m, k) x (nblk, k), A f32 or bf16-stored.

    Replaces ``_mv_kernel`` (navier_stokes_tpu/ops/pallas_mv.py:118).  Bound
    by the table stream: nblk*m*k*itemsize bytes / 3.35 TB/s."""
    _check_table(A, "block_mv table", (torch.float32, torch.bfloat16))
    _check_vec(x, A, "block_mv x")
    if _device_kind(A) == "cpu":
        return block_mv_plain(A, x)
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


# -- table applies ----------------------------------------------------------


def make_table_apply(A, store_dtype=torch.float32, device=None):
    """Batched block matvec fn (nblk, k) f32 -> (nblk, m) f32 for an
    (nblk, m, k) table (numpy or tensor), stored in ``store_dtype`` (f32 or
    bf16; arithmetic stays f32).  Counterpart of
    ``navier_stokes_tpu.ops.pallas_mv.make_table_apply``: every table apply
    goes through :func:`block_mv`, whatever the batch size."""
    if isinstance(A, np.ndarray):
        A = torch.from_numpy(np.ascontiguousarray(A))
    if device is None:
        device = A.device
    table = A.to(device=device, dtype=store_dtype).contiguous()

    def apply(x):
        return block_mv(table, x.contiguous())

    apply.table = table
    return apply

"""Hand-written CUDA batched element-local matvec, with its plain PyTorch
version.  Counterpart of ``navier_stokes_tpu/ops/pallas_kernels.py``.

:func:`batched_local_matvec` replaces ``_matvec_kernel`` /
``batched_local_matvec`` (pallas_kernels.py:26-60): y[e] = A[e] @ u[e] over
(ne, nb, nb) element blocks and (ne, nb) element vectors, in the dtype of
its inputs -- float32, or float64 (the model's default).  It is the product
the transient SIMPLE step is made of: the mass and condensed-operator
applies inside ``mstar``, ``_Mv`` and the step's right-hand side, and the
element-block Jacobi of the projection preconditioner.  The kernel lives in
``csrc/local_mv.cu`` (its own ``__global__`` template, instantiated for
float and double: one bulk asynchronous copy of a 32-row stretch per CTA,
one thread per row); it is bound by the table stream, ne*nb*nb*itemsize
bytes / 3.35 TB/s.

The wrapper checks device, dtype, shape and contiguity.  It takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the kernel
or raises.  Launches are counted in ``ops.block_mv.LAUNCHES``, per
instantiation: ``batched_local_matvec`` (float) and
``batched_local_matvec_f64`` (double).  The library is compiled from the
repository's source at first use
(:func:`~navier_stokes_tpu_torch.ops.block_mv.build_library`) and bound with
ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from .block_mv import LAUNCHES, _device_kind, _launch, _stream, build_library

__all__ = ["batched_local_matvec", "batched_local_matvec_plain",
           "load_library"]

_lib = None


def _bind(path):
    """The library at ``path`` with its entry points' argument types."""
    lib = ctypes.CDLL(str(path))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn in (lib.nstt_local_mv_f32, lib.nstt_local_mv_f64):
        fn.argtypes = [p, p, p, i64, i32, p]
        fn.restype = ctypes.c_int
    return lib


def load_library():
    """The compiled kernel as a ctypes library (built at first use)."""
    global _lib
    if _lib is None:
        _lib = _bind(build_library(name="local_mv")[0])
    return _lib


def batched_local_matvec_plain(a_local: torch.Tensor,
                               ue: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`batched_local_matvec`."""
    return torch.einsum("eij,ej->ei", a_local, ue)


def batched_local_matvec(a_local: torch.Tensor,
                         ue: torch.Tensor) -> torch.Tensor:
    """(ne, nb, nb) x (ne, nb) -> (ne, nb), float32 or float64 throughout.

    Replaces ``batched_local_matvec``
    (navier_stokes_tpu/ops/pallas_kernels.py:35).  Bound by the table
    stream: ne*nb*nb*itemsize bytes / 3.35 TB/s."""
    if a_local.dim() != 3 or a_local.shape[1] != a_local.shape[2]:
        raise ValueError("batched_local_matvec: expected (ne, nb, nb) blocks, "
                         f"got {tuple(a_local.shape)}")
    if a_local.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"batched_local_matvec: dtype {a_local.dtype} is "
                        "neither float32 nor float64")
    ne, nb, _ = a_local.shape
    if ue.dtype != a_local.dtype:
        raise TypeError(f"batched_local_matvec: blocks {a_local.dtype}, "
                        f"vectors {ue.dtype}")
    if tuple(ue.shape) != (ne, nb):
        raise ValueError(f"batched_local_matvec: expected vectors {(ne, nb)}, "
                         f"got {tuple(ue.shape)}")
    if ue.device != a_local.device:
        raise ValueError(f"batched_local_matvec: vectors on {ue.device}, "
                         f"blocks on {a_local.device}")
    if not (a_local.is_contiguous() and ue.is_contiguous()):
        raise ValueError("batched_local_matvec: operands must be contiguous")
    if _device_kind(a_local) == "cpu":
        return batched_local_matvec_plain(a_local, ue)
    y = torch.empty_like(ue)
    if y.numel() == 0:
        return y
    lib = load_library()
    f32 = a_local.dtype == torch.float32
    fn = lib.nstt_local_mv_f32 if f32 else lib.nstt_local_mv_f64
    _launch(fn, a_local.data_ptr(), ue.data_ptr(), y.data_ptr(), ne, nb,
            _stream(a_local))
    LAUNCHES["batched_local_matvec" if f32
             else "batched_local_matvec_f64"] += 1
    return y

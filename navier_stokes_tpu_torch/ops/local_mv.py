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
bytes / 3.35 TB/s.  :func:`batched_local_matvec_rect` runs the same kernel
on rectangular (ne, nout, nin) blocks, which the Pallas kernel does not
take: the dd solve's divergence couplings B and B^T
(``parallel/ddshard.py``), unpadded.

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
           "batched_local_matvec_rect", "load_library"]

_lib = None


def _bind(path):
    """The library at ``path`` with its entry points' argument types."""
    lib = ctypes.CDLL(str(path))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn in (lib.nstt_local_mv_f32, lib.nstt_local_mv_f64):
        fn.argtypes = [p, p, p, i64, i32, i32, p]
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
    return _local_mv(a_local, ue, "batched_local_matvec")


def batched_local_matvec_rect(a_local: torch.Tensor,
                              ue: torch.Tensor) -> torch.Tensor:
    """(ne, nout, nin) x (ne, nin) -> (ne, nout), float32 or float64
    throughout: :func:`batched_local_matvec`'s kernel on rectangular
    blocks.  Bound by the table stream: ne*nout*nin*itemsize bytes /
    3.35 TB/s."""
    if a_local.dim() != 3:
        raise ValueError("batched_local_matvec_rect: expected (ne, nout, "
                         f"nin) blocks, got {tuple(a_local.shape)}")
    return _local_mv(a_local, ue, "batched_local_matvec_rect")


def _local_mv(a_local, ue, name):
    if a_local.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {a_local.dtype} is "
                        "neither float32 nor float64")
    ne, nout, nin = a_local.shape
    if ue.dtype != a_local.dtype:
        raise TypeError(f"{name}: blocks {a_local.dtype}, vectors {ue.dtype}")
    if tuple(ue.shape) != (ne, nin):
        raise ValueError(f"{name}: expected vectors {(ne, nin)}, "
                         f"got {tuple(ue.shape)}")
    if ue.device != a_local.device:
        raise ValueError(f"{name}: vectors on {ue.device}, "
                         f"blocks on {a_local.device}")
    if not (a_local.is_contiguous() and ue.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if _device_kind(a_local) == "cpu":
        return batched_local_matvec_plain(a_local, ue)
    y = ue.new_empty((ne, nout))
    if y.numel() == 0:
        return y
    lib = load_library()
    f32 = a_local.dtype == torch.float32
    fn = lib.nstt_local_mv_f32 if f32 else lib.nstt_local_mv_f64
    _launch(fn, a_local.data_ptr(), ue.data_ptr(), y.data_ptr(), ne, nout,
            nin, _stream(a_local))
    LAUNCHES["batched_local_matvec" if f32
             else "batched_local_matvec_f64"] += 1
    return y

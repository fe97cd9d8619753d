"""Loader for the host setup kernels in C++ (meshkit), with fallbacks.

Counterpart of ``navier_stokes_tpu/utils/native.py``.  Compiles the port's
own ``native/meshkit.cpp`` with g++ at first use into the repository's
``build/`` directory (beside the CUDA libraries, named by a hash of the
source and the flags, written through a temporary file so that concurrent
processes never load a partial library) and binds it through ctypes.  The
contract is the JAX package's: :func:`build_edges` raises without the
toolchain; :func:`rcm_ordering` and :func:`extract_blocks_csr` fall back to
scipy / numpy with a warning.  This is host setup, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import warnings
from pathlib import Path

import numpy as np

from ..ops.block_mv import _BUILD_DIR

__all__ = ["available", "build_edges", "rcm_ordering", "extract_blocks_csr",
           "library_path"]

_SRC = Path(__file__).resolve().parent.parent / "native" / "meshkit.cpp"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB = None
_TRIED = False


def library_path() -> Path:
    """Where the compiled library of this source and these flags lives."""
    tag = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libmeshkit_{tag}.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        so = library_path()
        if not so.exists():
            _compile(so)
        lib = ctypes.CDLL(str(so))
        lib.build_edges.restype = ctypes.c_int64
        lib.build_edges.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.rcm_ordering.restype = None
        lib.rcm_ordering.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p
        ]
        lib.extract_blocks.restype = None
        lib.extract_blocks.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _LIB = lib
    except Exception as e:  # the toolchain is missing or failed
        warnings.warn(f"meshkit native kernels unavailable ({e}); "
                      "scipy/numpy fallback")
        _LIB = None
    return _LIB


def available() -> bool:
    """Whether the C++ kernels are compiled and loaded."""
    return _lib() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def build_edges(elements: np.ndarray, local_edges
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(edges (nedge, 2), element_edges (ne, nle), flips (ne, nle)).

    Edge ids are in first-seen order (opaque).  Raises RuntimeError
    without the C++ library."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native meshkit not available")
    elements = np.ascontiguousarray(elements, dtype=np.int32)
    le = np.ascontiguousarray(np.asarray(local_edges, dtype=np.int32))
    ne, npe = elements.shape
    nle = len(le)
    element_edges = np.empty((ne, nle), dtype=np.int32)
    flips = np.empty((ne, nle), dtype=np.uint8)
    edges_buf = np.empty((ne * nle, 2), dtype=np.int32)
    nedge = lib.build_edges(
        ne, npe, _ptr(elements), nle, _ptr(le),
        _ptr(element_edges), _ptr(flips), _ptr(edges_buf),
    )
    return edges_buf[:nedge].copy(), element_edges, flips.astype(bool)


def rcm_ordering(adj_csr) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of a scipy CSR adjacency matrix
    (scipy's ``reverse_cuthill_mckee`` without the C++ library)."""
    lib = _lib()
    n = adj_csr.shape[0]
    if lib is None:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        return np.asarray(reverse_cuthill_mckee(adj_csr.tocsr()),
                          dtype=np.int32)
    indptr = np.ascontiguousarray(adj_csr.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(adj_csr.indices, dtype=np.int32)
    perm = np.empty(n, dtype=np.int32)
    lib.rcm_ordering(n, _ptr(indptr), _ptr(indices), _ptr(perm))
    return perm


def extract_blocks_csr(A_csr, blocks_padded: np.ndarray) -> np.ndarray:
    """(nblocks, bmax, bmax) dense sub-blocks of the CSR matrix; padding
    rows/cols are identity.  ``blocks_padded``: (nblocks, bmax) int,
    -1-padded at the end of each row.  Without the C++ library: the
    numpy route, :func:`navier_stokes_tpu_torch.precond.jacobi.
    extract_blocks_csr`."""
    lib = _lib()
    if lib is None:
        from ..precond.jacobi import extract_blocks_csr as numpy_route

        return numpy_route(A_csr, blocks_padded)
    nblocks, bmax = blocks_padded.shape
    out = np.tile(np.eye(bmax), (nblocks, 1, 1))
    A = A_csr.tocsr()
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    blocks = np.ascontiguousarray(blocks_padded, dtype=np.int32)
    lib.extract_blocks(
        A.shape[0], _ptr(indptr), _ptr(indices), _ptr(data),
        nblocks, bmax, _ptr(blocks), _ptr(out),
    )
    return out

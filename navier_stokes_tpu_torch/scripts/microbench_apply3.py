"""Microbenchmark: the batched block matvec kernels against the einsum.

Counterpart of ``scripts/microbench_apply3.py``, the JAX script's four
variants at the bench shapes of ``channel_with_cylinder_mesh_3d(maxh)``
(maxh 0.09: a 7,740 x 54 x 54 float32 table of random face-major element
blocks, about 90 MB):

  1. einsum AoS matvec      ``torch.einsum`` (a ``bmm``) on the
                            array-of-structures (ne, nb, nb) table
  2. tiled_bmv kernel only  kernel 1 (``ops.block_mv.block_mv``) on the
                            same table
  3. face apply einsum /    the full scatter-free face-block apply
     face apply tiled_bmv   (``ops/faceblock.py``) around the einsum and
                            around kernel 1 (``elem_apply_tiled``)
  4. split einsum (2x) /    the split hi + lo apply as two einsums and as
     tiled_bmv_multi        kernel 2 (``block_mv2``: both tables in one
                            stream)

The JAX kernels read a tile-contiguous structure-of-arrays packing
(``pack_tiles``: (ntile, nb, nb, TILE), the element innermost) and the
JAX script transposes the element vectors between the layouts around
them.  The port's kernels read the array-of-structures table itself, one
bulk copy per CTA, so ``pack_tiles``, the transposes of variant 3 and the
script's ``tile`` argument have no counterpart here; the labels keep the
JAX script's names, each line names the port's kernel.

Each kernel line is held to its einsum line within the relative l2 bound
of ``microbench_apply2.DEV_TOL``.  The library lines run with TF32 off
(JAX's ``'highest'``; the flag is restored on exit).  Each line gets the
median of 25 calls with the L2 cache flushed (``utils/timers.KernelTimer``)
and the marginal slope between CUDA graphs of 10 and 60 chained applies
(``utils/timers.chain_slope_ms``, the JAX script's measure), and the
table bytes over the slope as GB/s.  On the CPU (``device="cpu"``) each
line runs once, is checked finite and has its deviation computed; no time
is taken.

Run: python -m navier_stokes_tpu_torch.scripts.microbench_apply3 [maxh]
     [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..fem.hdiv3d import HDiv3D
from ..mesh import channel_with_cylinder_mesh_3d
from ..models.stokes_hybrid3d import HybridVelocitySpace3D, VectorFacet3D
from ..ops.block_mv import block_mv, block_mv2
from ..ops.faceblock import FaceBlockLayout
from ..utils.timers import KernelTimer, chain_slope_ms
from .microbench_apply import rel_dev
from .microbench_apply2 import DEV_TOL


def main(maxh: float = 0.09, device=None):
    """Returns one dict per line, in the JAX script's order: ``label``,
    ``kernel`` (``library``, ``block_mv`` or ``block_mv2``), ``ms`` and
    ``graph_ms`` (None on the CPU), ``gbps`` (table bytes over
    ``graph_ms``), ``dev`` (relative l2 deviation of a kernel line from its
    einsum line; None for the einsum lines)."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    mesh = channel_with_cylinder_mesh_3d(maxh)
    Xv = HybridVelocitySpace3D(HDiv3D(mesh, 2), VectorFacet3D(mesh, 1))
    lay = FaceBlockLayout(Xv, device)
    ne, n, nb = mesh.ne, Xv.ndof, lay.nb
    gb = ne * nb * nb * 4 / 1e9
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"ne={ne} ndof={n} nb={nb} blocks={gb * 1e3:.1f} MB", flush=True)
    print(f"device: {name}", flush=True)

    rng = np.random.default_rng(0)
    A_np = lay.permute_blocks(
        rng.standard_normal((ne, nb, nb)).astype(np.float32))
    A_lo_np = (1e-7 * rng.standard_normal((ne, nb, nb))).astype(np.float32)
    u = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                        device=device)
    A, A_lo = lay.pack_elem_tables([A_np, lay.permute_blocks(A_lo_np)])
    x = torch.as_tensor(
        rng.standard_normal((nb, ne)).astype(np.float32).T.copy(),
        device=device)

    def mv_aos(ue):
        return torch.einsum("eij,ej->ei", A, ue)

    def split_einsum(ue):
        return (torch.einsum("eij,ej->ei", A, ue)
                + torch.einsum("eij,ej->ei", A_lo, ue))

    face_einsum = lay.elem_apply(A)
    face_kernel = lay.elem_apply_tiled([A])
    lines = (
        ("einsum AoS matvec", "library", mv_aos, x, 1),
        ("tiled_bmv kernel only", "block_mv", lambda v: block_mv(A, v), x, 1),
        ("face apply einsum", "library", face_einsum, u, 1),
        ("face apply tiled_bmv", "block_mv", face_kernel, u, 1),
        ("split einsum (2x)", "library", split_einsum, x, 2),
        ("tiled_bmv_multi", "block_mv2", lambda v: block_mv2(A, A_lo, v), x,
         2),
    )
    timer = KernelTimer() if on_card else None
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    try:
        y_lib = None
        for label, kernel, fn, v, ntab in lines:
            y = fn(v)
            if not bool(torch.isfinite(y).all()):
                raise RuntimeError(f"{label}: non-finite result")
            dev = None
            if kernel == "library":
                y_lib = y
            else:
                dev = rel_dev(y, y_lib)
                if dev > DEV_TOL:
                    raise RuntimeError(f"{label} ({kernel}): deviates by "
                                       f"{dev:.2e} from the einsum")
            ms = graph_ms = gbps = None
            timing = "not measured (no card)"
            if on_card:
                graph_ms = chain_slope_ms(fn, v)
                ms = timer(lambda fn=fn, v=v: fn(v))
                gbps = ntab * gb / (graph_ms * 1e-3)
                timing = (f"{graph_ms:.4f} ms ({gbps:.0f} GB/s) chained, "
                          f"{ms:.4f} ms eager")
            print(f"{label + ':':24s} [{kernel}] {timing}"
                  + ("" if dev is None else f"  dev {dev:.2e}"), flush=True)
            rows.append(dict(label=label, kernel=kernel, ms=ms,
                             graph_ms=graph_ms, gbps=gbps, dev=dev))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return rows


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("maxh", nargs="?", type=float, default=0.09)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, required)")
    args = ap.parse_args(argv)
    main(args.maxh, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())

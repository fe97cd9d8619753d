"""Microbenchmark: apply variants of the condensed 3D MCS operator.

Counterpart of ``scripts/microbench_apply.py``.  Measures y = A u for a
random table of per-element dense blocks (ne, nb, nb), float32 from
``default_rng(0)``, at the bench shapes of
``channel_with_cylinder_mesh_3d(maxh)`` (maxh 0.09: 7,740 x 54 x 54,
about 90 MB) three ways, in the JAX script's order:

  gather-einsum-scatter  ``ops.assembly.apply_local_matrices(...,
                         use_kernel=True)``: gather, kernel 8
                         (``ops.local_mv.batched_local_matvec``),
                         ``ScatterPlan``
  face-block apply       the scatter-free apply of ``ops/faceblock.py``
                         (``FaceBlockLayout.elem_apply(A_perm,
                         use_kernel=True)``: kernel 8), with the same apply
                         through kernel 1 (``elem_apply_tiled``:
                         ``block_mv``) beside it; each held to the first
                         variant's result within ``DEV_TOL``
  einsum only            ``torch.einsum`` (a ``bmm``) on the gathered
                         element vectors: no gather, no scatter -- the
                         library's lower bound, held to kernel 8 on the
                         same input

under each of the JAX script's matmul precisions.  JAX's ``'default'`` and
``'highest'`` become ``torch.backends.cuda.matmul.allow_tf32`` on and off.
That switch moves the library line only: the hand-written kernels compute
in float32 FMA either way.  The einsum under TF32 is held to ``TF32_TOL``
(TF32 keeps 10 bits of each factor's mantissa); the flag is restored on
exit.

Each line gets two times: ``graph_ms``, the marginal slope between CUDA
graphs of 10 and 60 chained applies (``utils/timers.chain_slope_ms``: the
device's time alone, as the JAX script's 50 chained applies in one jitted
loop), and ``ms``, the median of 25 eager calls with the L2 cache flushed
(``utils/timers.KernelTimer``), host launch gaps included.  On the CPU
(``device="cpu"``) each variant runs once, is checked finite and has its
deviation computed; no time is taken.

Run: python -m navier_stokes_tpu_torch.scripts.microbench_apply [maxh]
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
from ..ops import assembly as asm
from ..ops.faceblock import FaceBlockLayout
from ..ops.local_mv import batched_local_matvec
from ..utils.timers import KernelTimer, chain_slope_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
DEV_TOL = 1e-5  # relative l2 deviation of an f32 apply from another
TF32_TOL = 1e-2  # the same for the library's product under TF32
# JAX's matmul precision -> torch.backends.cuda.matmul.allow_tf32
PRECISIONS = (("default", True), ("highest", False))


def rel_dev(y, y_ref) -> float:
    """Relative l2 deviation of ``y`` from ``y_ref``."""
    return float(torch.linalg.norm((y - y_ref).double())
                 / torch.linalg.norm(y_ref.double()))


def main(maxh: float = 0.09, device=None):
    """Returns one dict per line, in the printed order: ``label``,
    ``precision`` (JAX's name), ``ms`` and ``graph_ms`` (None on the CPU),
    ``dev`` (relative l2 deviation from the line it is held to) and
    ``bound`` (the deviation allowed)."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    mesh = channel_with_cylinder_mesh_3d(maxh)
    Xv = HybridVelocitySpace3D(HDiv3D(mesh, 2), VectorFacet3D(mesh, 1))
    lay = FaceBlockLayout(Xv, device)
    ne, nface, n = mesh.ne, mesh.nface, Xv.ndof
    eldofs = np.asarray(Xv.element_dofs)
    nb = eldofs.shape[1]
    mb = ne * nb * nb * 4 / 1e6
    print(f"maxh={maxh} ne={ne} nface={nface} ndof={n} nb={nb} "
          f"A={mb:.0f}MB -> bound {mb * 1e6 / HBM_BYTES_PER_S * 1e3:.4f} ms "
          "at 3.35 TB/s", flush=True)

    rng = np.random.default_rng(0)
    A_np = rng.standard_normal((ne, nb, nb)).astype(np.float32)
    A = torch.as_tensor(A_np, device=device)
    u = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                        device=device)
    plan = asm.scatter_plan(torch.as_tensor(eldofs, device=device), n)
    A_perm = lay.permute_blocks(A_np)
    face8 = lay.elem_apply(torch.as_tensor(A_perm, device=device),
                           use_kernel=True)
    face1 = lay.elem_apply_tiled(lay.pack_elem_tables([A_perm]))
    ue0 = u[plan.index].contiguous()
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"device: {name}", flush=True)

    def gather_apply(v):
        return asm.apply_local_matrices(A, plan, n, v, use_kernel=True)

    def einsum_only(ue):
        return torch.einsum("eij,ej->ei", A, ue)

    timer = KernelTimer() if on_card else None
    saved = torch.backends.cuda.matmul.allow_tf32
    rows = []
    try:
        for prec, tf32 in PRECISIONS:
            torch.backends.cuda.matmul.allow_tf32 = tf32
            print(f"--- matmul precision = {prec} (allow_tf32={tf32})",
                  flush=True)
            y1 = gather_apply(u)
            y_ue = batched_local_matvec(A, ue0)
            lines = (
                ("gather-einsum-scatter", gather_apply, u, None, DEV_TOL),
                ("face-block apply", face8, u, y1, DEV_TOL),
                ("face-block apply (block_mv)", face1, u, y1, DEV_TOL),
                ("einsum only", einsum_only, ue0, y_ue,
                 TF32_TOL if tf32 else DEV_TOL),
            )
            for label, fn, x, y_ref, bound in lines:
                y = fn(x)
                if not bool(torch.isfinite(y).all()):
                    raise RuntimeError(f"{label}: non-finite result")
                dev = None if y_ref is None else rel_dev(y, y_ref)
                if dev is not None and dev > bound:
                    raise RuntimeError(f"{label} ({prec}): deviates by "
                                       f"{dev:.2e} (bound {bound:.0e})")
                ms = graph_ms = None
                timing = "not measured (no card)"
                if on_card:
                    graph_ms = chain_slope_ms(fn, x)
                    ms = timer(lambda fn=fn, x=x: fn(x))
                    timing = (f"{graph_ms:.4f} ms chained, {ms:.4f} ms "
                              "eager")
                print(f"  {label + ':':30s} {timing}"
                      + ("" if dev is None else f"  dev {dev:.2e}"),
                      flush=True)
                rows.append(dict(label=label, precision=prec, ms=ms,
                                 graph_ms=graph_ms, dev=dev, bound=bound))
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

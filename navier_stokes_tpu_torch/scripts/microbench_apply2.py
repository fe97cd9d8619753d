"""Microbenchmark: the batched element matvec in structure-of-arrays layout.

Counterpart of ``scripts/microbench_apply2.py``.  The face-block apply
(split -> 4-row gather -> batched (ne, 54, 54) x (ne, 54) matvec ->
two-sibling gather -> join) streams the element table in array-of-structures
order, (ne, nb, nb) with a 54-wide minor axis.  This measures the same
product with the ELEMENT on the fastest axis, A2 (nb, nb, ne_p):

  1. SoA einsum:  ``torch.einsum('ije,je->ie', A2, ueT)`` alone, and the
     hand-written SoA kernel (``ops.stream_mv.block_mv_soa``) alone
  2. the full face-block apply around the SoA einsum (gather AoS ->
     transpose)
  3. the full face-block apply around the SoA kernel, its deviation from 2
     printed and checked
  4. the yardstick: the same face-block apply through ``block_mv`` on the
     AoS table, which is what the solve runs

Times are medians of 25 calls from CUDA events with the L2 cache flushed
before each.  A face apply is about a dozen launches, so on a slow host its
eager time holds launch gaps; beside it stands the time of the same apply
replayed as a CUDA graph, which is the device's alone (the JAX script times
a jitted chain for the same reason).  On the CPU (``device="cpu"``) the
wrappers take their plain versions and no time is taken.

Run: python -m navier_stokes_tpu_torch.scripts.microbench_apply2 [maxh]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..device import resolve_device
from ..fem.hdiv3d import HDiv3D
from ..mesh import channel_with_cylinder_mesh_3d
from ..models.stokes_hybrid3d import HybridVelocitySpace3D, VectorFacet3D
from ..ops import stream_mv as sm
from ..ops.faceblock import FaceBlockLayout
from ..utils.timers import Timer, graphed

TILE = 256  # the element count is padded to a multiple of it
DEV_TOL = 1e-5  # relative l2 deviation between the two SoA face applies


def main(maxh: float = 0.09, device=None):
    """Returns one dict per measurement: ``label``, ``ms`` and ``graph_ms``
    (eager, and replayed as a CUDA graph; None on the CPU), ``dev``
    (relative l2 deviation from the same measurement around the SoA einsum;
    None for the einsum's own lines)."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    mesh = channel_with_cylinder_mesh_3d(maxh)
    Xv = HybridVelocitySpace3D(HDiv3D(mesh, 2), VectorFacet3D(mesh, 1))
    lay = FaceBlockLayout(Xv, device)
    ne, n, nb = mesh.ne, Xv.ndof, lay.nb
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"ne={ne} ndof={n} nb={nb}", flush=True)
    print(f"device: {name}", flush=True)

    rng = np.random.default_rng(0)
    A_np = rng.standard_normal((ne, nb, nb)).astype(np.float32)
    u = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                        device=device)
    A_perm = lay.permute_blocks(A_np)
    A2 = sm.pack_soa(A_perm, TILE, device)  # (nb, nb, ne_p)
    ne_p = A2.shape[2]
    ueT0 = torch.as_tensor(
        rng.standard_normal((nb, ne_p)).astype(np.float32), device=device)
    print(f"table: ({nb}, {nb}, {ne_p}) f32, {A2.numel() * 4 / 1e6:.1f} MB",
          flush=True)

    soa_einsum = sm.face_apply_soa(lay, A2, sm.block_mv_soa_plain)
    soa_kernel = sm.face_apply_soa(lay, A2)
    aos_kernel = lay.elem_apply_tiled(lay.pack_elem_tables([A_perm]))
    timer = Timer() if on_card else None

    def measure(label, fn, y_ref=None):
        y = fn()
        if on_card:
            torch.cuda.synchronize()
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError(f"{label}: non-finite result")
        dev = None
        if y_ref is not None:
            dev = float(torch.linalg.norm(y - y_ref)
                        / torch.linalg.norm(y_ref))
            if dev > DEV_TOL:
                raise RuntimeError(f"{label}: deviates by {dev:.2e} from the "
                                   "SoA einsum's result")
        ms = graph_ms = None
        timing = "not measured (no card)"
        if on_card:
            ms, graph_ms = timer(fn), timer(graphed(fn))
            timing = f"{ms:.4f} ms, as a CUDA graph {graph_ms:.4f} ms"
        print(f"{label:28s} {timing}"
              + ("" if dev is None else f"  dev {dev:.2e}"), flush=True)
        return {"label": label, "ms": ms, "graph_ms": graph_ms,
                "dev": dev}, y

    rows = []
    row, y1 = measure("SoA einsum only:",
                      lambda: sm.block_mv_soa_plain(A2, ueT0))
    rows.append(row)
    row, _ = measure("SoA kernel only:", lambda: sm.block_mv_soa(A2, ueT0),
                     y1)
    rows.append(row)
    row, y2 = measure("face apply (SoA einsum):", lambda: soa_einsum(u))
    rows.append(row)
    # padding columns (e >= ne) hold zeros and must come out zero
    ueT = torch.cat([ueT0[:, :ne], ueT0.new_zeros((nb, ne_p - ne))], dim=1)
    pad = sm.block_mv_soa(A2, ueT.contiguous())[:, ne:]
    if pad.numel() and float(pad.abs().max()) != 0.0:
        raise RuntimeError("block_mv_soa: padding columns came out non-zero")
    row, _ = measure("face apply (SoA kernel):", lambda: soa_kernel(u), y2)
    rows.append(row)
    row, _ = measure("face apply (AoS block_mv):", lambda: aos_kernel(u), y2)
    rows.append(row)
    return rows


if __name__ == "__main__":
    main(*(float(a) for a in sys.argv[1:2]))

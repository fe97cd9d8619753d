"""Audit the per-apply table stream of the flagship preconditioner.

Counterpart of ``scripts/audit_tables.py``.  Builds the flagship operators
(the curved f64 model and ``equilibrated_f32_ops`` with bench.py's
settings) and prints, first, the JAX script's cost model from the layout's
quantities, line for line as it prints it: six rows (table, MB of 2^20
bytes, streams per apply, MB per apply), their total per phase-1 iteration
and the edge-star size histogram.  Then the port's actual device tables --
every table of ``preA.parts["tables"]`` and the A32, B32, BT32 tables --
with their stored dtype, MB (10^6 bytes), streams per preA apply (per
phase-1 iteration for A32, B32, BT32) and MB per apply; the GS solve
tables by segment per sweep direction beside the padded layout of the JAX
package that they stand for; and the byte bound of one phase-1 iteration
at the H100's 3.35 TB/s, with the card's name and power limit.  (The JAX
script's lines at 150 and 819 GB/s are TPU rates and are left out.)

On the card the stream counts are checked: across one ``preA`` apply the
launches of each kernel wrapper (``ops.block_mv.LAUNCHES``) must equal the
streams the audit gives the tables that wrapper applies; a mismatch
raises.  On the CPU the wrappers take their plain versions and launch
nothing, so only the tables are printed.

Run: python -m navier_stokes_tpu_torch.scripts.audit_tables [maxh]
     [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..bench import card_name
from ..device import resolve_device
from ..ops import block_mv as bm
from ..ops.faceblock import _edge_star_faces

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory


def jax_cost_model(m, maxh) -> list[str]:
    """The JAX script's printed lines (scripts/audit_tables.py:36-80) for
    the model ``m``, without its two TPU-rate lines."""
    mesh = m.mesh
    lay = m.fb
    ne, nfb, nface = lay.ne, lay.nfb, lay.nface
    n_skel, n_int = lay.n_skel, lay.n_int
    nedge = mesh.nedge
    out = [f"maxh={maxh}: ne={ne} nface={nface} nedge={nedge} "
           f"nfb={nfb} n_skel={n_skel} n_int={n_int} ndof={m.n}"]
    S_f32 = ne * n_skel * n_skel * 4
    MB = 1.0 / 2**20
    sizes = np.array([len(f) for f in _edge_star_faces(mesh)])
    inv_bytes = int(np.sum((sizes * nfb) ** 2) * 4)
    panel_bytes = 3 * nface * nfb * 2 * n_skel * 4  # per direction
    ext_bytes = ne * n_int * n_skel * 2  # bf16 ext (default)
    inner_bytes = ne * n_int * n_int * 2
    nb_full = n_skel + n_int
    A_bytes = 2 * ne * nb_full * nb_full * 4
    rows = [
        ("A32 hi+lo tables (1 stream/apply)", A_bytes, 1),
        ("S element blocks f32 (coarse residual, 1/apply)", S_f32, 1),
        ("GS row panels (3 S-equiv x 2 directions)", panel_bytes, 2),
        ("edge-star inverses (1/direction)", inv_bytes, 2),
        ("ext+extT tables bf16 (1 each/apply)", ext_bytes, 2),
        ("interior-inverse table bf16 (1/apply)", inner_bytes, 1),
    ]
    tot = 0.0
    out.append(f"\n{'table':52s} {'size MB':>9s} {'x':>2s} {'MB/apply':>9s}")
    for name, b, k in rows:
        out.append(f"{name:52s} {b*MB:9.1f} {k:2d} {b*k*MB:9.1f}")
        tot += b * k * MB
    out.append(f"{'TOTAL preA+A stream per phase-1 iteration':52s} "
               f"{'':9s} {'':2s} {tot:9.1f}")
    out.append(f"\nedge-star size histogram: "
               f"{dict(zip(*map(list, np.unique(sizes, return_counts=True))))}")
    return out


def preA_streams(parts) -> dict:
    """Streams per preA apply of each table of ``parts["tables"]``: once
    each the extension, its transpose, the interior solve, M_F and M_F^T
    (one coarse correction), S (the coarse residual) and, additive, each
    edge-star bucket; a GS color's solve table twice (forward and backward
    sweep) and its panels twice, but once for the first color, whose
    forward step starts from the zero iterate."""
    out = {}
    for name in parts["tables"]:
        if name.startswith("GS color "):
            c = int(name.split()[2])
            out[name] = 1 if name.endswith("panels") and c == 0 else 2
        elif name in ("ext", "ext^T", "inner", "M_F", "M_F^T", "S") \
                or name.startswith("edge-star inv "):
            out[name] = 1
        else:
            raise ValueError(f"audit_tables: no stream count for {name!r}")
    return out


def _bytes(t) -> int:
    if isinstance(t, bm.SegmentTable):
        return t.real_bytes
    if isinstance(t, list):
        return sum(_bytes(s) for s in t)
    return t.numel() * t.element_size()


def _dtype(t) -> str:
    t = t.data if isinstance(t, bm.SegmentTable) else t
    t = t[0] if isinstance(t, list) else t
    return str(t.dtype).replace("torch.", "")


def _wrapper(t) -> str:
    """The launch counter of the kernel that applies table ``t``."""
    return "block_mv_splitk" if isinstance(t, list) else "block_mv"


def main(maxh: float = 0.3, device=None, solver=None):
    """Print the audit (see the module docstring).  ``solver``: an already
    built :class:`~navier_stokes_tpu_torch.flagship.FlagshipSolve`; else the
    curved f64 model at ``maxh`` is built on ``device`` with
    ``equilibrated_f32_ops``' defaults.  Returns a dict: ``jax_lines`` (the
    JAX script's lines), ``tables`` (name, dtype, bytes, streams),
    ``stream_bytes`` (per phase-1 iteration), ``bound_ms``, ``launches``
    (per wrapper across one preA apply; None on the CPU)."""
    if solver is None:
        from ..flagship import build_model
        from ..solvers.refinement import equilibrated_f32_ops

        m = build_model(maxh, device=resolve_device(device))
        ops32 = equilibrated_f32_ops(m, with_ds=False)[0]
    else:
        m, ops32 = solver.m, solver.ops32
    jax_lines = jax_cost_model(m, maxh)
    for line in jax_lines:
        print(line, flush=True)

    preA = ops32["preA"]
    tabs = preA.parts["tables"]
    streams = preA_streams(preA.parts)
    rows = [(name, _dtype(t), _bytes(t), streams[name], _wrapper(t))
            for name, t in tabs.items()]
    rows += [(f"{op}32 (per phase-1 iteration)", _dtype(ops32[op].tables),
              _bytes(ops32[op].tables), 1, None) for op in ("A", "B", "BT")]
    MB = 1e-6
    print(f"\nport tables (MB = 10^6 bytes)\n{'table':40s} {'dtype':>9s} "
          f"{'MB':>9s} {'x':>2s} {'MB/apply':>9s}", flush=True)
    total = 0
    for name, dt, b, k, _ in rows:
        print(f"{name:40s} {dt:>9s} {b*MB:9.2f} {k:2d} {b*k*MB:9.2f}",
              flush=True)
        total += b * k
    solves = [t for name, t in tabs.items() if name.endswith(" solve")]
    if solves:
        real = sum(t.real_bytes for t in solves)
        padded = sum(t.nblk * t.width ** 2 * t.data.element_size()
                     for t in solves)
        print(f"{'GS solve tables by segment (1/direction)':40s} "
              f"{'':>9s} {real*MB:9.1f}\n"
              f"{'GS solve tables padded, JAX layout':40s} {'':>9s} "
              f"{padded*MB:9.1f}", flush=True)
    bound_ms = total / HBM_BYTES_PER_S * 1e3
    card = card_name() if m.device.type == "cuda" else "no card"
    print(f"{'TOTAL preA + A32 + B32 + BT32 per phase-1 iteration':52s} "
          f"{total*MB:9.1f} MB\nbound at the H100's 3.35 TB/s: "
          f"{bound_ms:.4f} ms per phase-1 iteration ({card})", flush=True)

    launches = None
    if m.device.type == "cuda":
        want = {}
        for name, _, _, k, wrapper in rows:
            if wrapper is not None:
                want[wrapper] = want.get(wrapper, 0) + k
        u = torch.ones(m.n, dtype=torch.float32, device=m.device)
        torch.cuda.synchronize()
        before = dict(bm.LAUNCHES)
        preA(u)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in bm.LAUNCHES.items()
                    if v != before[k]}
        print(f"launches across one preA apply {launches}, streams the audit "
              f"gives {want}", flush=True)
        if launches != want:
            raise RuntimeError(f"audit_tables: launches {launches} differ "
                               f"from the audited streams {want}")
    return dict(jax_lines=jax_lines,
                tables=[r[:4] for r in rows], stream_bytes=total,
                bound_ms=bound_ms, launches=launches)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("maxh", nargs="?", type=float, default=0.3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, required)")
    args = ap.parse_args(argv)
    main(args.maxh, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())

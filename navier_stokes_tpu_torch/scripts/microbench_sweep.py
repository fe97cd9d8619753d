"""Microbenchmark: where the GS preconditioner's milliseconds go.

Counterpart of ``scripts/microbench_sweep.py``.  Times every constituent of
the flagship solve's preconditioner -- the symmetric multicolor block-GS
skeleton preconditioner of ``equilibrated_f32_ops(m64, gs=True, split=True,
with_ds=False)`` on the curved f64 model -- at the flagship's own shapes:

  preA        the full preconditioner
  pre_skel    the symmetric sweep (forward colors + S residual + coarse +
              backward colors)
  fwd_sweep   the forward color loop alone
  one_color   one mid-sweep color step (residual panels + segment solve +
              slot gather)
  P_only      the middle color's panel table alone, at its own input shape
  solve_only  the middle color's solve table alone, at its own input shape
  S_faces     the full skeleton operator apply
  coarse      the damped auxiliary-space coarse correction

Each piece gets two numbers.  ``replay_ms``: the marginal slope between
CUDA graphs of 10 and 60 chained applies (``utils/timers.chain_slope_ms``,
the JAX script's chains of jitted applies): the device's time alone.
``eager_ms``: a run of back-to-back eager applies
(``utils/timers.per_apply_ms``), host launch gaps included; the difference
is the host's share.  Then one line per GS color: the color step's graph
replay (``utils/timers.KernelTimer``: median of 25, L2 flushed) and the
share of it that the same step's row gathers (``x[faces]``,
``y[elem_faces]``, ``r[rows]``, ``y[slot]``), captured alone in a graph,
take.  A piece that fails, or cannot be captured, raises.  On the CPU
(``device="cpu"``) each piece is applied once and checked finite; no time
is taken.

Run: python -m navier_stokes_tpu_torch.scripts.microbench_sweep [maxh]
     [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..utils.timers import KernelTimer, chain_slope_ms, graphed, per_apply_ms

PIECES = ("preA", "pre_skel", "fwd_sweep", "one_color", "P_only",
          "solve_only", "S_faces", "coarse")


def pieces(preA, n: int):
    """(name, fn, x) for each of :data:`PIECES`, in order, from the parts of
    a GS skeleton preconditioner ``preA`` of ``n`` velocity dofs (f32)."""
    parts = preA.parts
    lay, sm, groups = parts["layout"], parts["smoother"], parts["groups"]
    nface, nfb = lay.nface, lay.nfb
    dev = lay.device
    f32 = torch.float32
    rng = np.random.default_rng(3)
    xF = torch.as_tensor(rng.standard_normal((nface, nfb)),
                         device=dev).to(f32)
    xF = torch.where(sm.freeF, xF, 0.0)
    u32 = torch.ones(n, dtype=f32, device=dev)
    gmid = groups[len(groups) // 2]

    def _pad(x):
        return torch.cat([x, x.new_zeros((1, nfb))])

    def fwd_sweep(x):
        xP = _pad(x)
        y = None
        for g in groups:
            dy = sm.solve_color_rows(g, xP, y)
            y = dy if y is None else y + dy
        return y[:-1]

    def one_color(x):
        xP = _pad(x)
        return sm.solve_color_rows(gmid, xP, xP)[:-1]

    # the middle color's tables at their own input shapes
    ye = torch.as_tensor(
        rng.standard_normal((gmid.elem_faces.shape[0], 8 * nfb)),
        device=dev).to(f32)
    xb = torch.as_tensor(
        rng.standard_normal((gmid.rows.shape[0], gmid.solve.table.width)),
        device=dev).to(f32)
    return [
        ("preA", preA, u32),
        ("pre_skel", parts["pre_skel"], xF),
        ("fwd_sweep", fwd_sweep, xF),
        ("one_color", one_color, xF),
        ("P_only", gmid.panels, ye),
        ("solve_only", gmid.solve, xb),
        ("S_faces", parts["S_faces"], xF),
        ("coarse", parts["coarse_only"], xF),
    ]


def color_steps(preA):
    """(color, step, gathers) per GS color: ``step()`` is the color's
    mid-sweep step, ``gathers()`` the same step's four row gathers alone
    (the solve output they read made once beforehand)."""
    parts = preA.parts
    lay, sm, groups = parts["layout"], parts["smoother"], parts["groups"]
    nfb = lay.nfb
    rng = np.random.default_rng(5)
    xP = torch.as_tensor(rng.standard_normal((lay.nface + 1, lay.nfb)),
                         device=lay.device).to(torch.float32)
    xP[-1] = 0.0
    out = []
    for c, g in enumerate(groups):
        yb = g.solve(xP[g.faces][g.rows].reshape(g.rows.shape[0], -1))

        def step(g=g):
            return sm.solve_color_rows(g, xP, xP)

        def gathers(g=g, yb=yb):
            rc = xP[g.faces]
            ye = xP[g.elem_faces]
            rb = rc[g.rows]
            return rb, ye, yb.reshape(-1, nfb)[g.slot]

        out.append((c, step, gathers))
    return out


def main(maxh: float = 0.09, device=None, solver=None):
    """Time each piece (see the module docstring).  ``solver``: an already
    built :class:`~navier_stokes_tpu_torch.flagship.FlagshipSolve` whose
    ``preA`` is timed; else the curved f64 model at ``maxh`` is built on
    ``device`` with ``equilibrated_f32_ops(m64, gs=True, split=True,
    with_ds=False)``.  Returns one dict per piece (``piece``,
    ``replay_ms``, ``eager_ms``; None on the CPU) and per GS color
    (``piece`` "color c", ``replay_ms``, ``gather_ms``,
    ``gather_share``)."""
    if solver is None:
        from ..flagship import build_model
        from ..solvers.refinement import equilibrated_f32_ops

        t0 = time.perf_counter()
        m64 = build_model(maxh, device=resolve_device(device))
        ops32, _ = equilibrated_f32_ops(m64, gs=True, split=True,
                                        with_ds=False)
        preA, n, dev = ops32["preA"], m64.n, m64.device
        print(f"setup {time.perf_counter() - t0:.1f}s ndof={n}", flush=True)
    else:
        preA, n, dev = solver.ops32["preA"], solver.m.n, solver.m.device
    on_card = dev.type == "cuda"
    groups = preA.parts["groups"]
    gmid = groups[len(groups) // 2]
    print(f"ncolors={len(groups)} panels(mid)={tuple(gmid.panels.table.shape)}"
          f" solve(mid)={gmid.rows.shape[0]}x{gmid.solve.table.width}",
          flush=True)
    timer = KernelTimer() if on_card else None
    rows = []
    for name, fn, x in pieces(preA, n):
        y = fn(x)
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError(f"microbench_sweep: {name} is not finite")
        row = {"piece": name, "replay_ms": None, "eager_ms": None}
        if on_card:
            row.update(replay_ms=chain_slope_ms(fn, x),
                       eager_ms=per_apply_ms(fn, x))
            print(f"  {name:12s} {row['replay_ms']:8.4f} ms replay "
                  f"{row['eager_ms']:8.4f} ms eager (host share "
                  f"{1 - row['replay_ms'] / row['eager_ms']:.3f})",
                  flush=True)
        else:
            print(f"  {name:12s} not measured (no card)", flush=True)
        rows.append(row)
    for c, step, gathers in color_steps(preA):
        for y in (step(), *gathers()):
            if not bool(torch.isfinite(y).all()):
                raise RuntimeError(f"microbench_sweep: color {c} step is "
                                   "not finite")
        row = {"piece": f"color {c}", "replay_ms": None, "gather_ms": None,
               "gather_share": None}
        if on_card:
            ms, gms = timer(graphed(step)), timer(graphed(gathers))
            row.update(replay_ms=ms, gather_ms=gms, gather_share=gms / ms)
            print(f"  color {c:<6d} {ms:8.4f} ms replay, row gathers alone "
                  f"{gms:8.4f} ms ({gms / ms:.3f})", flush=True)
        rows.append(row)
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

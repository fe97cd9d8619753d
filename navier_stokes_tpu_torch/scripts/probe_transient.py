"""Per-piece probe of one f32 SIMPLE transient step.

Counterpart of ``scripts/probe_transient.py``.  Times the pieces of one
step of the float32 stepping model (bench.py's ``measure_transient``
settings: ``project_tol=1e-5``, M* CG to 1e-4), by the JAX script's names
and in its order, with the CG counts:

  rhs = conv+f-A_raw, conv alone, A_raw alone   the explicit right-hand side
  mstar CG (tol 1e-4)                           with its count
  Minv (cheb deg16), B_raw, BT,
  S apply (B Minv BT), twolevel pre             the projection's applies
  projection CG (tol 1e-5)                      with its count and err0
  FUSED STEP                                    the step as bench.py runs it
  in-step counts                                ``m.last_iterations``

then three more applies the step is made of (``mass_raw``, ``mstar
apply``, ``twolevel block``).  ``A_raw`` is the step's own route (the
condensed table through kernel 8), so the CG counts are the step's.  A
single apply gets its graph replay (``replay_ms``: the marginal slope
between CUDA graphs of 10 and 60 chained applies,
``utils/timers.chain_slope_ms``) and its eager time (``eager_ms``,
``utils/timers.per_apply_ms``); the CG solves and the step read the host,
so they take the host clock (``host_ms``: the median of 3 calls, each
ending in a synchronize).  A piece that fails, or cannot be captured,
raises.  On the CPU (``device="cpu"``) each piece runs once, its output is
checked finite, and no time is taken.

Run: python -m navier_stokes_tpu_torch.scripts.probe_transient [maxh]
     [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..device import resolve_device
from ..solvers.cg import cg
from ..utils.timers import chain_slope_ms, host_ms, per_apply_ms

MSTAR_TOL, PROJECT_TOL = 1e-4, 1e-5  # bench.py's step settings
MAXSTEPS = 2000


def _finite(name, out):
    ts = out if isinstance(out, tuple) else (out,)
    for t in ts:
        if isinstance(t, torch.Tensor) and not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"probe_transient: {name} is not finite")


def probe(m, u=None, step=None, log=print):
    """The pieces of one step of the f32 model ``m`` from ``u`` (default
    ``m.u``) with the step function ``step`` (default
    ``m.make_step_fn(project_tol=1e-5)``).  Each line goes to ``log``.
    Returns one dict per piece: ``piece``, and ``replay_ms`` / ``eager_ms``
    (single applies) or ``host_ms`` (solves, the step), None on the CPU;
    the solves' ``iterations`` and ``converged`` (and ``err0``); the
    in-step counts ``mstar`` and ``project``."""
    on_card = m.device.type == "cuda"
    u = m.u if u is None else u
    if step is None:
        step = m.make_step_fn(project_tol=PROJECT_TOL, mstar_tol=MSTAR_TOL)
    free, f = m.free, m.f
    conv, A_raw = m.convection, m._A_raw_step
    Minv, pre2 = m._mass_chebyshev(), m._pre_proj_twolevel()

    def S(p):
        return m.B(Minv(m.BT(p)))

    def rhs(v):
        return torch.where(free, conv(v) + f - A_raw(v), 0.0)

    rows = []

    def apply_row(name, fn, x):
        y = fn(x)
        _finite(name, y)
        row = {"piece": name, "replay_ms": None, "eager_ms": None}
        if on_card:
            row.update(replay_ms=chain_slope_ms(fn, x),
                       eager_ms=per_apply_ms(fn, x, k=10))
            log(f"  {name:34s} {row['replay_ms']:10.4f} ms replay "
                f"{row['eager_ms']:10.4f} ms eager")
        else:
            log(f"  {name:34s} not measured (no card)")
        rows.append(row)
        return y

    def solve_row(name, fn):
        out = fn()
        _finite(name, getattr(out, "x", out))
        row = {"piece": name, "host_ms": None}
        if on_card:
            row["host_ms"] = host_ms(fn)
            log(f"  {name:34s} {row['host_ms']:10.1f} ms (host clock, "
                "median of 3)")
        else:
            log(f"  {name:34s} not measured (no card)")
        rows.append(row)
        return out, row

    temp = apply_row("rhs = conv+f-A_raw", rhs, u)
    apply_row("conv alone", conv, u)
    apply_row("A_raw alone", A_raw, u)
    res, row = solve_row(
        "mstar CG (tol 1e-4)",
        lambda: cg(m.mstar, temp, pre=m.preMstar, tol=MSTAR_TOL,
                   maxsteps=MAXSTEPS))
    row.update(iterations=int(res.iterations), converged=bool(res.converged))
    log(f"    mstar its={row['iterations']} converged={row['converged']}")
    temp2 = res.x
    apply_row("Minv (cheb deg16)", Minv, temp2)
    p0 = m.B_raw(u)
    apply_row("B_raw", m.B_raw, temp2)
    apply_row("BT", m.BT, p0)
    apply_row("S apply (B Minv BT)", S, p0)
    apply_row("twolevel pre", pre2, p0)
    rhs_p = m.B_raw(temp2)
    res, row = solve_row(
        "projection CG (tol 1e-5)",
        lambda: cg(S, rhs_p, pre=pre2, tol=PROJECT_TOL, maxsteps=MAXSTEPS))
    row.update(iterations=int(res.iterations), converged=bool(res.converged),
               err0=float(res.err0))
    log(f"    proj its={row['iterations']} converged={row['converged']} "
        f"err0={row['err0']:.3e}")
    solve_row("FUSED STEP", lambda: step(u))
    counts = dict(m.last_iterations)  # the step's last call's
    rows.append({"piece": "in-step counts", "mstar": int(counts["mstar"]),
                 "project": int(counts["project"])})
    log(f"  in-step counts: mstar={counts['mstar']} "
        f"proj={counts['project']}")
    apply_row("mass_raw", m._mass_raw, u)
    apply_row("mstar apply", m.mstar, u)
    apply_row("twolevel block", pre2.block, p0)
    return rows


def main(maxh: float = 0.09, device=None, m=None):
    """Probe one step (see the module docstring).  ``m``: an already built
    float32 stepping model, probed from its state ``m.u``; else the curved
    f32 model at ``maxh`` is built on ``device``.  Returns
    :func:`probe`'s rows."""
    if m is None:
        from ..flagship import build_model

        t0 = time.perf_counter()
        m = build_model(maxh, device=resolve_device(device),
                        dtype=torch.float32)
        print(f"f32 model build {time.perf_counter() - t0:.1f}s "
              f"ndof={m.n}+{m.Q.ndof}", flush=True)
    t0 = time.perf_counter()
    step = m.make_step_fn(project_tol=PROJECT_TOL, mstar_tol=MSTAR_TOL)
    print(f"step setup {time.perf_counter() - t0:.1f}s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in m.setup_seconds.items()),
          flush=True)
    print(f"probe device: {m.device}, {m.mesh.ne} tets", flush=True)
    return probe(m, step=step, log=lambda s: print(s, flush=True))


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

"""The port's bench line: ``python -m navier_stokes_tpu_torch.bench``.

Counterpart of ``bench.py``'s one JSON line (bench.py:759-783), on the card.
It runs bench.py's configuration -- the 3D MCS channel with the order-3
curved cylinder at maxh = 0.09, the curved multicolor-GS flagship solve to
a true f64 relative residual of 1e-8 in at most 460 inner iterations, and
the float32 transient SIMPLE step at projection tolerance 1e-5 -- and
prints exactly one line on standard output::

    {"metric": "mcs3d_initial_stokes_to_residual_1e-8", "value": ...,
     "unit": "...", "vs_baseline": ..., "steps_per_sec": ...,
     "steps_vs_baseline": ...}

``value`` is inner Krylov iterations per second of the warm solve
(``flagship.FlagshipSolve.full_solve``, after a cold one);
``steps_per_sec`` the warm transient steps per second
(``flagship.transient_steps``: one cold step, one step to calibrate, then
about 10 s of steps, 3 to 200).  ``vs_baseline`` and ``steps_vs_baseline``
divide by the JAX package's CPU measurement kept in ``BASELINE_CPU.json``
(54.207 s for 408 inner iterations; 0.006509 steps/s), which is read, never
re-measured; ``unit`` says so and names the card and its power limit.

There is no CPU fallback and no budget skip: without a CUDA device, a solve
that misses the residual or the iteration budget, or a step that is not
finite, the module raises and exits non-zero with no line printed.
:func:`measure` takes models already built (``chip_smoke.py`` prints the
line from its own models); progress goes to standard error.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from .flagship import FlagshipSolve, build_model, transient_steps

__all__ = ["METRIC", "MAXH", "TOL", "MAX_INNER", "PROJECT_TOL", "KEYS",
           "BASELINE_PATH", "load_baseline", "card_name", "check_solve",
           "bench_line", "time_steps", "measure", "main"]

METRIC = "mcs3d_initial_stokes_to_residual_1e-8"
MAXH = 0.09
TOL = 1e-8
MAX_INNER = 460  # bench.py's iteration budget at maxh = 0.09
PROJECT_TOL = 1e-5  # the f32 step's projection tolerance (bench.py)
KEYS = ("metric", "value", "unit", "vs_baseline", "steps_per_sec",
        "steps_vs_baseline")
BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "BASELINE_CPU.json")
CONFIG = f"3D MCS channel maxh={MAXH}"
# the configuration the baseline was measured for (bench.py:_baseline_config)
BASELINE_CONFIG = {"metric": METRIC, "maxh": MAXH, "tol": TOL,
                   "geom": f"{MAXH}_curved", "gs": 1}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_baseline(path: str = BASELINE_PATH) -> dict:
    """The CPU baseline of bench.py's configuration, as recorded in
    ``BASELINE_CPU.json``; raises if it is missing or was measured for
    another configuration."""
    with open(path) as fh:
        art = json.load(fh)
    if art.get("config") != BASELINE_CONFIG:
        raise ValueError(f"{path}: baseline of {art.get('config')}, not "
                         f"{BASELINE_CONFIG}")
    for key in ("solve_wall_s", "solve_inner", "transient_steps_per_sec"):
        if not art.get(key):
            raise ValueError(f"{path}: no {key}")
    return art


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_solve(res, label: str, max_inner: int | None = MAX_INNER,
                tol: float = TOL):
    """Raise unless the flagship result ``res`` met the true f64 residual
    (to 1.01 ``tol``, as bench.py) within ``max_inner`` inner iterations."""
    if not res.true_rel <= 1.01 * tol:
        raise RuntimeError(f"{label}: true f64 residual {res.true_rel:.3e} "
                           f"above {tol}")
    if max_inner is not None and res.inner > max_inner:
        raise RuntimeError(f"{label}: {res.inner} inner iterations, over "
                           f"the budget of {max_inner}")


def bench_line(inner: int, seconds: float, steps_per_sec: float,
               baseline: dict, card: str) -> dict:
    """bench.py's JSON line from the warm solve's inner count and seconds
    and the warm steps per second, divided by the recorded baseline."""
    vs = baseline["solve_wall_s"] / seconds
    steps_vs = steps_per_sec / baseline["transient_steps_per_sec"]
    unit = (
        f"inner Krylov iterations/sec (split-f32 MINRES refinement + "
        f"compensated double-single polish), {CONFIG}, "
        f"wall={seconds:.3f}s to f64 rel residual {TOL} on {card} "
        f"(PyTorch + CUDA port); transient SIMPLE loop "
        f"{steps_per_sec:.4g} steps/s (f32, proj tol {PROJECT_TOL}); "
        f"vs_baseline = CPU wall {baseline['solve_wall_s']}s for "
        f"{baseline['solve_inner']} inner iterations / device wall, "
        f"steps_vs_baseline = steps/s / CPU "
        f"{baseline['transient_steps_per_sec']} steps/s, both from "
        f"BASELINE_CPU.json (the JAX package's bench.py on the jax-CPU "
        f"backend, measured {baseline['measured_utc']}; not re-measured)")
    return {"metric": METRIC, "value": round(inner / seconds, 2),
            "unit": unit, "vs_baseline": round(vs, 3),
            "steps_per_sec": float(f"{steps_per_sec:.4g}"),
            "steps_vs_baseline": round(steps_vs, 3)}


def _sync(m):
    if m.device.type == "cuda":
        torch.cuda.synchronize(m.device)


def time_steps(m32, n_steps: int | None = None):
    """Warm transient steps of the float32 model ``m32`` from its state, as
    bench.py's ``measure_transient``: one cold step, one to calibrate
    ``n_steps`` to about 10 s (3 to 200) unless given, then ``n_steps``
    timed.  Returns (n_steps, seconds, counts of the timed steps)."""
    u, _ = transient_steps(m32, 1, PROJECT_TOL)  # the lazy setup and a step
    _sync(m32)
    t0 = time.perf_counter()
    u, _ = transient_steps(m32, 1, PROJECT_TOL, u=u)
    _sync(m32)
    dt1 = time.perf_counter() - t0
    if n_steps is None:
        n_steps = max(3, min(200, int(10.0 / max(dt1, 1e-3))))
    t0 = time.perf_counter()
    u, counts = transient_steps(m32, n_steps, PROJECT_TOL, u=u)
    _sync(m32)
    seconds = time.perf_counter() - t0
    if not bool(torch.isfinite(u).all()):
        raise RuntimeError("transient steps are not finite")
    return n_steps, seconds, counts


def measure(m, m32, solver: FlagshipSolve | None = None, cold=None,
            warm=None, n_steps: int | None = None,
            max_inner: int | None = MAX_INNER, card: str | None = None):
    """bench.py's measurement on models already built: ``m`` the float64
    model (``flagship.build_model``), ``m32`` its float32 stepping twin,
    ``solver`` a ``FlagshipSolve`` of ``m`` (built here unless given).
    A cold and a warm ``full_solve``, unless their results are given as
    ``cold`` and ``warm`` (a caller that has just solved passes them), each
    checked by :func:`check_solve`; then :func:`time_steps`.  Returns
    (line, info): the JSON line's dict and the cold and warm results with
    the step counts."""
    baseline = load_baseline()
    if card is None:
        card = card_name()
    if (cold is None) != (warm is None):
        raise ValueError("give both the cold and the warm result, or neither")
    if warm is None:
        if solver is None:
            solver = FlagshipSolve(m, tol=TOL)
        cold = solver.full_solve()
    check_solve(cold, "cold solve", max_inner)
    log(f"[bench] cold: {cold.inner} inner, {cold.seconds:.3f} s, "
        f"true rel {cold.true_rel:.3e}")
    if warm is None:
        warm = solver.full_solve()
    check_solve(warm, "warm solve", max_inner)
    log(f"[bench] warm: {warm.inner} inner, {warm.seconds:.3f} s, "
        f"true rel {warm.true_rel:.3e}")
    n, seconds, counts = time_steps(m32, n_steps)
    log(f"[bench] transient: {n} warm steps in {seconds:.3f} s")
    line = bench_line(warm.inner, warm.seconds, n / seconds, baseline, card)
    return line, {"cold": cold, "warm": warm, "n_steps": n,
                  "step_seconds": seconds, "step_counts": counts}


def main(argv=None) -> int:
    """Build bench.py's models on the card, measure, print the line."""
    if argv:
        raise SystemExit(f"usage: python -m navier_stokes_tpu_torch.bench "
                         f"(no arguments; got {argv})")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cache = {}  # host tables shared by the f64 model and its f32 twin
    m = build_model(MAXH, device="cuda", assembly_cache=cache)
    m32 = build_model(MAXH, device="cuda", assembly_cache=cache,
                      dtype=torch.float32, mesh=m.mesh, geometry=m.geometry)
    del cache
    log(f"[bench] models built in {time.perf_counter() - t0:.1f} s, "
        f"ndof={m.n}+{m.Q.ndof}")
    line, _ = measure(m, m32)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

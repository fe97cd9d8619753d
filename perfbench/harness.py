"""One run of one cell of the benchmark.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything particular to a cell is found by name: the cell in
``BENCHMARK.json`` names its configuration and traffic mix;
``configs/<config>.json`` holds the configuration's sizes and limits and
``configs/<config>.py`` builds the program's objects (``System``) and
holds the check against the plain reference and the byte counts;
``traffic/<mix>.json`` names the op one unit of the window runs, its
parameters and the end-to-end metric the window gives; each per-layer
metric is read by ``metrics/<metric>.py``.  This file is the one general
driver: set-up, a closed-loop window of whole units, the traced units, the
check, and the result line.

The window ends at the end of the unit that crosses ``--seconds``; that
unit counts.  With ``--trace 1``, ``trace_units`` more units run after the
window under ``torch.profiler`` (kept in memory, reduced there) and the
line carries the per-layer metrics; with ``--trace 0`` it carries the
end-to-end ones.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

__all__ = ["main", "run", "draw_um", "wrap_span", "Parts", "load_module",
           "FORBIDDEN_MODULES"]

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "navier_stokes_tpu")


class NoResult(Exception):
    """A run that must end without a result line (exit code 2)."""


def draw_um(spec: dict, seed: int) -> float:
    """The inflow speed Um of a run: uniform on the configuration's range,
    drawn from the seed."""
    lo, hi = spec["um"]
    return float(np.random.default_rng(seed).uniform(lo, hi))


def wrap_span(obj, name: str, span, label: str | None = None) -> None:
    """Replace the callable attribute ``name`` of ``obj`` (on the instance)
    by one that runs it inside the span ``label``; a missing attribute is
    left alone, and its span is then missing from the trace."""
    fn = getattr(obj, name, None)
    if fn is None or not callable(fn):
        return
    label = label or name

    def wrapped(*a, **k):
        with span(label):
            return fn(*a, **k)

    setattr(obj, name, wrapped)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Parts:
    """Seconds of each named part of the set-up, each ended by a device
    synchronize."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        self.sync()
        self.seconds[name] = time.perf_counter() - t0

    def add(self, more: dict) -> None:
        self.seconds.update(more)


def lean_profiler(on_cuda: bool):
    """A started ``torch.profiler`` that records the device's operations
    and the host's launch calls, and of the host's ranges only the
    harness's own spans (``record_function``, the user scope): no ``aten``
    op is recorded, so tracing adds little to each launch."""
    import torch.autograd.profiler as autograd_profiler
    from torch._C._profiler import RecordScope
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if on_cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    enable = autograd_profiler._enable_profiler

    def user_scope_only(config, activities, *_a, **_k):
        return enable(config, activities, {RecordScope.USER_SCOPE})

    autograd_profiler._enable_profiler = user_scope_only
    try:
        prof.start()
    finally:
        autograd_profiler._enable_profiler = enable
    return prof


def forbidden_loaded() -> list:
    """Top-level names in ``sys.modules`` that the program must not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def load_cell(name: str, bench: dict | None = None) -> dict:
    """The cell ``name`` with its configuration, traffic, per-layer metrics
    (those that list the cell or list no cells) and end-to-end metrics."""
    bench = bench or json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise NoResult(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {
        "cell": cell,
        "config": cfg,
        "spec": json.loads((REPO / cfg["file"]).read_text()),
        "module": load_module(REPO / (cfg["file"][:-len(".json")] + ".py"),
                              "perfbench_config_" + cfg["name"]
                              .replace("-", "_").replace(".", "_")),
        "traffic": json.loads(
            (ROOT / "traffic" / f"{cell['traffic']}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def read_metric(name: str, ctx: dict):
    """The value of per-layer metric ``name`` (``metrics/<name>.py``'s
    ``read``), or None where it finds nothing to read."""
    mod = load_module(ROOT / "metrics" / f"{name}.py",
                      "perfbench_metric_" + name.replace(".", "_"))
    return mod.read(ctx)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda", chips_check: bool = True,
        overrides: dict | None = None, breakers=None,
        min_units: int = 1) -> dict:
    """One run; returns the result object (the line to print).
    ``device="cpu"`` with ``chips_check=False`` drives the program's plain
    versions; ``overrides`` replace keys of the configuration (a smaller
    ``maxh``), ``breakers(system)`` may break the program's unit and
    ``min_units`` makes the window hold at least that many units: the
    tests' hooks."""
    import torch

    cell = load_cell(workload)
    spec, traffic, mod = cell["spec"], cell["traffic"], cell["module"]
    spec = {**spec, **(overrides or {})}
    chips = cell["cell"]["chips"]
    if chips_check:
        if not torch.cuda.is_available():
            raise NoResult("no CUDA device: torch.cuda.is_available() is "
                           "false")
        if torch.cuda.device_count() < chips:
            raise NoResult(f"the cell needs {chips} devices, "
                           f"{torch.cuda.device_count()} visible")
    on_cuda = torch.device(device).type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    parts = Parts(sync)
    with parts("kernel libraries"):
        if on_cuda:
            from navier_stokes_tpu_torch.ops.block_mv import build_all
            build_all()
    system = mod.System(spec, seed, traffic, device, parts)
    if breakers is not None:
        breakers(system)
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {workload} seed {seed}: setup_s {setup_s:.3f}; Um "
        f"{system.um:.6f}; parts: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in parts.seconds.items()))

    # -- the window --------------------------------------------------------
    unit_name = traffic["unit"]
    units, t_ends = [], []
    t0 = time.perf_counter()
    while True:
        units.append(system.run_unit())
        t_ends.append(time.perf_counter())
        if t_ends[-1] - t0 >= seconds and len(units) >= min_units:
            break
    sync()
    t_ends[-1] = time.perf_counter()
    window_s = t_ends[-1] - t0
    n_window = len(units)
    dts = np.diff([t0] + t_ends)
    log(f"[window] {n_window} {unit_name}s in {window_s:.3f} s ("
        f"{window_s / n_window * 1e3:.2f} ms per {unit_name}); host-clock "
        f"time per {unit_name}: median {np.median(dts) * 1e3:.2f} ms, p95 "
        f"{np.percentile(dts, 95) * 1e3:.2f} ms, min "
        f"{dts.min() * 1e3:.2f} ms, max {dts.max() * 1e3:.2f} ms")

    # -- the traced units, after the window: once started, the profiler
    # leaves the host's launches slower for the rest of the process -------
    summary = None
    if trace:
        from torch.profiler import record_function

        from perfbench.trace import reduce_events

        def span(label):
            return record_function("pb:" + label)

        system.add_spans(span)
        n_traced = int(traffic.get("trace_units", 1))
        prof = lean_profiler(on_cuda)
        with span("window"):
            for _ in range(n_traced):
                with span(unit_name):
                    units.append(system.run_unit())
            sync()
        prof.stop()
        t_red = time.perf_counter()
        summary = reduce_events(prof.profiler.kineto_results.events())
        del prof
        busy = summary.busy_s() / n_traced
        log(f"[trace] {n_traced} {unit_name}s traced, reduced in "
            f"{time.perf_counter() - t_red:.1f} s; device busy "
            f"{busy * 1e3:.2f} ms per {unit_name}: "
            f"{100 * busy * n_traced / summary.window_s:.2f} % of a traced "
            f"{unit_name}'s wall time, {100 * busy / np.median(dts):.2f} % "
            f"of an untraced one's (median)")
    n_units = len(units)
    failed = sum(bool(u.get("failed")) for u in units)
    log(f"[units] {n_units} {unit_name}s; failed {failed}; counters "
        + json.dumps({k: [u[k] for u in units] for k in units[0]
                      if k != "failed"}))
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    log(f"[memory] peak {peak} bytes")

    # -- the check -----------------------------------------------------------
    material = system.release(np.random.default_rng([seed, 1]))
    del system
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    found = forbidden_loaded()
    if found:
        raise NoResult(f"forbidden modules loaded: {found}")
    t_ref = time.perf_counter()
    checks = mod.check(spec, material, device, log=log)
    log(f"[reference] {time.perf_counter() - t_ref:.1f} s")
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)

    # -- the metrics ---------------------------------------------------------
    metrics = {}
    if trace:
        ctx = {"trace": summary, "units": units,
               "window_units": units[:n_window], "window_s": window_s,
               "traced_units": units[n_window:], "spec": spec,
               "traffic": traffic, "config": mod, "device": device}
        for m in cell["per_layer"]:
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        wm = traffic["window_metric"]
        values = {"setup_s": setup_s,
                  wm["name"]: window_s / n_window * wm["per_unit_scale"]}
        for m in cell["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
           "count": chips if on_cuda else 0,
           "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        dev["busy_s"] = summary.busy_s()
        dev["window_s"] = summary.window_s
        breakdown = {"device_ops": summary.top_ops(10),
                     "idle_gaps": summary.idle_gaps(10)}
    result = result_line(correct, n_units, failed, metrics, dev, checks,
                         breakdown)
    found = forbidden_loaded()
    if found:
        raise NoResult(f"forbidden modules loaded: {found}")
    return result


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: list, breakdown: dict | None = None
                ) -> dict:
    """The result object, its keys in order; the numbers compared, each
    beside its limit, under ``checks``, last."""
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return out


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    build = REPO / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(build / sub)
    try:
        import navier_stokes_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"[error] the program is not importable: {e}")
        return 2
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start)
    except NoResult as e:
        log(f"[error] {e}")
        return 2
    for name, c in result["checks"].items():
        log(f"[check] {name} {c['value']:.6e} limit {c['limit']:.6e}")
    print(json.dumps(result), flush=True)
    return 0

"""Shared by the readers of the program's own spans
(``navier_stokes_tpu_torch/utils/tracing.py``): the spans the program
recorded inside the traced window, and the device's idle time put down to
them.

Each device-idle interval of the window is split by overlap between the
innermost program spans open on the host at each instant: a gap that
starts in a host read and runs on into the next operator apply is shared
between the two (the harness's ``idle_gaps`` charges a whole gap to the
span open when it began).  Each device operation counts, by the host time
of its launch, for every span name on the path from the innermost span
then open up to its root.

Computed once per run and kept in ``ctx``; the summary is printed as one
``[program-spans]`` line on stderr.  A program without spans (no
``tracing`` module, or no span in the window) gives None, and so does a
window in which the program's list of spans was full (``tracing.
dropped``): counts and shares would then read too low.
"""

from __future__ import annotations

import bisect
import json
import sys
from collections import Counter

__all__ = ["KRYLOV", "program_spans", "per_iteration", "summarize",
           "idle_intervals"]

# the solvers' root spans; "Krylov self" is idle time whose innermost span
# is one of them or one of their ``.read`` spans
KRYLOV = ("cg", "bpcg", "minres", "lanczos")


def _krylov_self(name: str) -> bool:
    return name in KRYLOV or (name.endswith(".read")
                              and name[:-len(".read")] in KRYLOV)


def idle_intervals(trace) -> list:
    """The device's idle intervals inside the traced window, in order
    (none where the trace has no device operation)."""
    if not trace.device_ops:
        return []
    w0, w1 = trace.window
    ops = sorted((max(s, w0), min(e, w1)) for s, e, _, _ in
                 trace.device_ops if e > w0 and s < w1)
    gaps, t = [], w0
    for s, e in ops:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def _segments(recs: list, keep: list) -> list:
    """(start, end, innermost span index or None) pieces covering the
    kept spans' time, in order.  The spans of one thread nest."""
    marks = []
    for i in keep:
        r = recs[i]
        marks.append((r.start, 1, i))
        marks.append((r.end, 0, -i))
    # at one instant: ends before starts, the inner end first, the outer
    # start first
    marks.sort()
    segs, stack, t = [], [], None
    for when, kind, i in marks:
        if t is not None and when > t:
            segs.append((t, when, stack[-1] if stack else None))
        t = when
        if kind == 1:
            stack.append(i)
        elif stack:
            stack.pop()
    return segs


def summarize(trace, recs: list, n_units: int) -> dict | None:
    """The per-name summary of the program spans ``recs`` (objects with
    ``name``, ``start``, ``end``, ``parent``, ``root``, ``attrs``; the
    indices into ``recs``) that lie inside ``trace.window``, per unit of
    ``n_units``.  None without such a span."""
    w0, w1 = trace.window
    keep = [i for i, r in enumerate(recs) if r.end is not None
            and r.start >= w0 and r.end <= w1]
    if not keep or n_units <= 0:
        return None
    kept = set(keep)
    segs = _segments(recs, keep)
    seg_starts = [s for s, _, _ in segs]

    count, self_ns = Counter(), Counter()
    child_ns = Counter()
    for i in keep:
        r = recs[i]
        count[r.name] += 1
        if r.parent is not None and r.parent in kept:
            child_ns[r.parent] += r.end - r.start
    for i in keep:
        r = recs[i]
        self_ns[r.name] += r.end - r.start - child_ns[i]

    iterations, reads = Counter(), 0
    for i in keep:
        r = recs[i]
        if r.name.endswith(".read"):
            reads += 1
        if r.name in KRYLOV and "iterations" in r.attrs:
            iterations[r.name] += int(r.attrs["iterations"])

    has_device = bool(trace.device_ops)
    idle_ns, device_ns = Counter(), Counter()
    total_idle = covered = krylov_self = 0
    if has_device:
        # the idle intervals split over the innermost spans, by overlap
        gaps = idle_intervals(trace)
        j = 0
        for g0, g1 in gaps:
            total_idle += g1 - g0
            while j < len(segs) and segs[j][1] <= g0:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < g1:
                s0, s1, i = segs[k]
                ov = min(g1, s1) - max(g0, s0)
                if ov > 0 and i is not None:
                    name = recs[i].name
                    idle_ns[name] += ov
                    if recs[i].parent is not None:
                        covered += ov
                    if _krylov_self(name):
                        krylov_self += ov
                k += 1
        # device time by the span names open at each operation's launch
        for s, e, _, t_launch in trace.device_ops:
            if t_launch is None:
                continue
            k = bisect.bisect_right(seg_starts, t_launch) - 1
            if k < 0 or t_launch > segs[k][1] or segs[k][2] is None:
                continue
            names, i = set(), segs[k][2]
            while i is not None:
                names.add(recs[i].name)
                i = recs[i].parent
            for name in names:
                device_ns[name] += e - s

    def per_unit_ms(ns):
        return round(ns * 1e-6 / n_units, 6)

    spans = {}
    for name in sorted(count, key=lambda n: -self_ns[n]):
        spans[name] = {"count": count[name],
                       "host_self_ms": per_unit_ms(self_ns[name])}
        if has_device:
            spans[name]["idle_ms"] = per_unit_ms(idle_ns[name])
            spans[name]["device_ms"] = per_unit_ms(device_ns[name])
    out = {"units": n_units, "spans": spans, "reads": reads,
           "host_syncs": sum(trace.syncs.values()),
           "iterations": dict(iterations)}
    if has_device:
        out.update(idle_ms=per_unit_ms(total_idle),
                   covered_pct=(round(100.0 * covered / total_idle, 3)
                                if total_idle else None),
                   krylov_self_idle_ms=per_unit_ms(krylov_self))
    out["_ns"] = {"idle": dict(idle_ns), "device": dict(device_ns),
                  "krylov_self_idle": krylov_self}
    return out


def program_spans(ctx) -> dict | None:
    """The summary of the run's traced window (once per run; see
    :func:`summarize`), or None where the program recorded no span."""
    if "program_spans" in ctx:
        return ctx["program_spans"]
    out = None
    trace = ctx.get("trace")
    try:
        from navier_stokes_tpu_torch.utils import tracing
    except ImportError:  # a program without spans
        tracing = None
    if trace is not None and tracing is not None:
        n_dropped, first = tracing.dropped()
        if n_dropped and first <= trace.window[1]:
            print(f"[program-spans] {n_dropped} spans not recorded, the "
                  f"program's list full from {first} ns: no reading",
                  file=sys.stderr, flush=True)
        else:
            out = summarize(trace, tracing.records(),
                            len(ctx["traced_units"]))
    ctx["program_spans"] = out
    if out is not None:
        shown = {k: v for k, v in out.items() if k != "_ns"}
        print("[program-spans] " + json.dumps(shown), file=sys.stderr,
              flush=True)
    return out


def per_iteration(ctx, value_of, solver: str):
    """``value_of(summary)`` over the ``solver`` root spans' iterations in
    the window, or None."""
    s = program_spans(ctx)
    if s is None:
        return None
    its = s["iterations"].get(solver, 0)
    value = value_of(s)
    return None if value is None or its == 0 else value / its

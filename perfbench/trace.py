"""The traced part of a window: ``torch.profiler`` kept in memory and reduced
there to what the per-layer readers need.  No trace file is written.

The reduction reads the profiler's raw events once:

* device operations (kernels, copies, sets; not the annotations mirrored
  onto the device's timeline): their intervals, names and the correlation
  id that ties each to the host call that launched it;
* host calls that put work on the device (kernel and graph launches,
  asynchronous copies and sets), counted by name;
* the benchmark's own spans, ``record_function`` ranges named ``pb:<layer>``
  that the harness opens around the calls into each layer.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from dataclasses import dataclass, field

__all__ = ["SPAN_PREFIX", "TraceSummary", "reduce_events", "union_length"]

SPAN_PREFIX = "pb:"
# host calls that enqueue device work
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                   "cuGraphLaunch", "cudaMemcpyAsync", "cuMemcpy",
                   "cudaMemsetAsync", "cuMemset")
HOST_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cuStreamSynchronize")


def union_length(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


@dataclass
class TraceSummary:
    """What a traced window held, in nanoseconds of the profiler's clock.

    ``window``: (start, end) of the span ``pb:window``; ``device_ops``: per
    device operation (start, end, name, launch time on the host or None);
    ``launches``: host launch calls by name; ``syncs``: host waits by name;
    ``spans``: per span name its (start, end) intervals on the host."""

    window: tuple
    device_ops: list = field(default_factory=list)
    launches: Counter = field(default_factory=Counter)
    syncs: Counter = field(default_factory=Counter)
    spans: dict = field(default_factory=lambda: defaultdict(list))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_s(self) -> float:
        w0, w1 = self.window
        return union_length(
            (max(s, w0), min(e, w1)) for s, e, _, _ in self.device_ops
            if e > w0 and s < w1) * 1e-9

    def launch_count(self) -> int:
        return sum(self.launches.values())

    def device_s_under(self, span: str) -> float:
        """Device seconds of the operations launched inside a ``span``
        interval (by the host time of their launch)."""
        ivs = sorted(self.spans.get(span, ()))
        starts = [s for s, _ in ivs]
        total = 0
        for s, e, _, t_launch in self.device_ops:
            if t_launch is None:
                continue
            i = bisect.bisect_right(starts, t_launch) - 1
            if i >= 0 and ivs[i][0] <= t_launch <= ivs[i][1]:
                total += e - s
        return total * 1e-9

    def top_ops(self, k: int = 10) -> list:
        by_name = Counter()
        for s, e, name, _ in self.device_ops:
            by_name[name] += e - s
        return [[name, ns * 1e-9] for name, ns in by_name.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle time inside the window, by the innermost
        benchmark span open on the host when the gap began."""
        w0, w1 = self.window
        ops = sorted((max(s, w0), min(e, w1)) for s, e, _, _ in
                     self.device_ops if e > w0 and s < w1)
        gaps, t = [], w0
        for s, e in ops:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
        # one sweep over span starts, span ends and gap starts in time
        # order; the spans of one thread nest, so the innermost open span
        # is the top of a stack
        marks = []
        for name, ivs in self.spans.items():
            if name == SPAN_PREFIX + "window":
                continue
            for s, e in ivs:
                marks.append((s, 1, name[len(SPAN_PREFIX):]))
                marks.append((e, 0, None))
        for g0, g1 in gaps:
            marks.append((g0, 2, g1 - g0))
        marks.sort(key=lambda m: (m[0], m[1]))
        stack, by_span = [], Counter()
        for _, kind, what in marks:
            if kind == 1:
                stack.append(what)
            elif kind == 0:
                if stack:
                    stack.pop()
            else:
                by_span[stack[-1] if stack else "outside any span"] += what
        return [[name, ns * 1e-9] for name, ns in by_span.most_common(k)]


def reduce_events(events) -> TraceSummary:
    """A :class:`TraceSummary` of the profiler's raw events
    (``prof.profiler.kineto_results.events()``)."""
    host_launch = {}
    device, calls = [], []
    spans = defaultdict(list)
    for ev in events:
        name = ev.name()
        on_device = str(ev.device_type()).endswith("CUDA")
        if on_device:
            if not ev.is_user_annotation():
                device.append((ev.start_ns(), ev.start_ns()
                               + ev.duration_ns(), name, ev.correlation_id()))
            continue
        if name.startswith(SPAN_PREFIX):
            spans[name].append((ev.start_ns(),
                                ev.start_ns() + ev.duration_ns()))
        elif name.startswith(LAUNCH_PREFIXES):
            host_launch[ev.correlation_id()] = ev.start_ns()
            calls.append((name, ev.start_ns(), True))
        elif name in HOST_SYNCS:
            calls.append((name, ev.start_ns(), False))
    windows = spans.get(SPAN_PREFIX + "window")
    if not windows:
        raise ValueError("the trace holds no pb:window span")
    window = (min(s for s, _ in windows), max(e for _, e in windows))
    ops = [(s, e, name, host_launch.get(corr)) for s, e, name, corr in device]
    launches, syncs = Counter(), Counter()
    for name, t, is_launch in calls:
        if window[0] <= t <= window[1]:
            (launches if is_launch else syncs)[name] += 1
    return TraceSummary(window=window, device_ops=ops, launches=launches,
                        syncs=syncs, spans=spans)

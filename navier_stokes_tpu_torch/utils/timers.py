"""CUDA-event timers.

Counterpart of ``navier_stokes_tpu/utils/timers.py``.  There a named
wall-clock scope fences with ``block_until_ready``; on the card the device's
own clock is read instead: CUDA events recorded on the current stream
around the work, so that asynchronous launches cannot hide device time and
the host's launch gaps ahead of the work are not counted.
"""

from __future__ import annotations

import statistics

import torch

__all__ = ["Timer", "per_apply_ms", "graphed"]

_COVER_CYCLES = 2_000_000  # device spin ahead of each timed call (Timer)


class Timer:
    """Median time of one call on the card, from CUDA events around each
    call, with the 50 MB L2 cache flushed before every call (on the main
    path every table arrives cold: the others stream through in between).

    Between the flush and the start event the device spins for
    ``_COVER_CYCLES`` (about 1 ms at the H100's 1.98 GHz): the host's work
    ahead of the call's first launch -- a wrapper's checks, allocations
    and ctypes call, which on a slow host can outlast the flush -- then
    overlaps the spin instead of landing between the events, and the time
    measured is the device's, from the call's first launch to its end."""

    def __init__(self, reps: int = 25):
        self.reps = reps
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                 device="cuda")  # 256 MB

    def __call__(self, fn) -> float:
        """Median milliseconds of ``fn()`` over ``reps`` calls."""
        fn()
        torch.cuda.synchronize()
        evs = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(_COVER_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in evs)


def per_apply_ms(fn, x, k: int = 20) -> float:
    """Milliseconds per apply over a run of k back-to-back applies (a
    solve's own steady state, host launch gaps included)."""
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(k):
        fn(x)
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / k


def graphed(fn):
    """``fn()`` captured once as a CUDA graph; returns its replay, which
    runs the same launches with no host work between them.  Timing the
    replay times the device alone, as the JAX package's jitted chains do;
    ``fn`` must not read the device from the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capturing stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay

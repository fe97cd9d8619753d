"""Timers.

Counterpart of ``navier_stokes_tpu/utils/timers.py``: :class:`Timer` is its
named wall-clock scope, fenced with ``torch.cuda.synchronize`` where the
reference runs ``block_until_ready``.  Beside it the card's own clock:
:class:`KernelTimer` reads CUDA events recorded on the current stream
around a call, so that asynchronous launches cannot hide device time and
the host's launch gaps ahead of the work are not counted.
"""

from __future__ import annotations

import statistics
import time

import torch

from ..ops.block_mv import device_spin

__all__ = ["Timer", "KernelTimer", "per_apply_ms", "graphed"]

_COVER_CYCLES = 2_000_000  # device spin ahead of each timed call (KernelTimer)


def _fence(obj) -> None:
    """Wait for the card on which each CUDA tensor in ``obj`` (a tensor, or
    lists, tuples and dicts of them) lives; anything else passes."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            torch.cuda.synchronize(obj.device)
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            _fence(item)
    elif isinstance(obj, dict):
        for item in obj.values():
            _fence(item)


class Timer:
    """Named wall-clock timer; .time accumulates across Start/Stop pairs."""

    def __init__(self, name: str = ""):
        self.name = name
        self.time = 0.0
        self._t0 = None

    def Start(self):
        self._t0 = time.perf_counter()
        return self

    def Stop(self, *fence):
        """Stop timing; the cards of any CUDA tensors passed are
        synchronized first."""
        for x in fence:
            _fence(x)
        self.time += time.perf_counter() - self._t0
        return self.time

    def __enter__(self):
        return self.Start()

    def __exit__(self, *exc):
        self.Stop()
        return False


class KernelTimer:
    """Median time of one call on the card, from CUDA events around each
    call, with the 50 MB L2 cache flushed before every call (on the main
    path every table arrives cold: the others stream through in between).

    Between the flush and the start event the device spins for
    ``_COVER_CYCLES`` (about 1 ms at the H100's 1.98 GHz;
    ``ops.block_mv.device_spin``): the host's work ahead of the call's
    first launch -- a wrapper's checks, allocations and ctypes call, which
    on a slow host can outlast the flush -- then overlaps the spin instead
    of landing between the events, and the time measured is the device's,
    from the call's first launch to its end."""

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
            device_spin(_COVER_CYCLES)
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

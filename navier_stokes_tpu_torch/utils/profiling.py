"""Profiling hook: the reference's TaskManager(pajetrace=...) equivalent.

The reference captures Paje traces through NGSolve's TaskManager behind a
``-p`` flag (run.py:218-219, 239); the JAX package wraps
``jax.profiler.trace``.  Here ``torch.profiler`` records the host and, where
there is one, the CUDA device, and writes a Chrome trace into ``logdir``.
"""

from __future__ import annotations

import contextlib
import os
import time

__all__ = ["maybe_profile"]


@contextlib.contextmanager
def maybe_profile(enabled: bool, logdir: str = "profile_trace"):
    """Record a ``torch.profiler`` trace of the block when ``enabled``
    (written as ``logdir/trace_<pid>_<ns>.json``), else do nothing."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir,
                        f"trace_{os.getpid()}_{time.monotonic_ns()}.json")
    prof.export_chrome_trace(path)
    print(f"profile trace written to {path}")

"""Parity of the port's named wall-clock ``Timer`` with the JAX package's.

``navier_stokes_tpu_torch.utils.timers.Timer`` is the counterpart of
``navier_stokes_tpu.utils.timers.Timer``: ``Start()`` returns the timer,
``Stop(*fence)`` fences on what it is given (``torch.cuda.synchronize`` on
the card of each CUDA tensor, where the reference runs
``block_until_ready``), adds the elapsed ``time.perf_counter`` time to
``.time`` and returns it, and the timer works as a context manager.  Both
run the same sequence of calls, each on its own copy of one scripted
clock, so their ``.time`` must agree exactly.  The CUDA-event ``KernelTimer`` and the device spin it
runs are checked on the card, in ``tests/test_torch_cuda.py``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navier_stokes_tpu.utils.timers as jax_timers
import navier_stokes_tpu_torch.utils.timers as torch_timers
from navier_stokes_tpu.utils.timers import Timer as JaxTimer
from navier_stokes_tpu_torch.utils.timers import Timer

STEPS = [0.25, 1.5, 0.125, 2.0, 0.5, 3.0, 0.75, 4.0]  # seconds per read


@pytest.fixture
def clock(monkeypatch):
    """Each timers module reads its own scripted ``time.perf_counter``,
    which advances by the next of ``STEPS`` at each read: the same calls
    give both modules the same readings."""
    for mod in (jax_timers, torch_timers):
        steps = iter(STEPS * 4)
        now = [100.0]

        def perf_counter(steps=steps, now=now):
            now[0] += next(steps)
            return now[0]

        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(perf_counter=perf_counter))


def _run(cls, fence):
    """One scripted sequence: two Start/Stop pairs, a context-manager scope,
    a third pair; returns the timer and what each Stop returned."""
    t = cls("assemble")
    got = []
    assert t.Start() is t
    got.append(t.Stop(fence))
    t.Start()
    got.append(t.Stop())
    with t as inside:
        assert inside is t
    t.Start()
    got.append(t.Stop(fence, fence))
    return t, got


def test_timer_accumulates_as_the_jax_timer(clock):
    jt, jgot = _run(JaxTimer, jnp.ones(3))
    tt, tgot = _run(Timer, torch.ones(3))
    assert tt.time == jt.time
    assert tgot == jgot
    # the four scopes take the steps that end them: 1.5 + 2.0 + 3.0 + 4.0
    assert tt.time == pytest.approx(10.5)


def test_timer_stop_returns_its_time(clock):
    t = Timer("solve")
    first = t.Start().Stop()
    assert first == t.time > 0
    second = t.Start().Stop()
    assert second == t.time > first


def test_timer_is_a_context_manager(clock):
    jt, tt = JaxTimer("step"), Timer("step")
    for _ in range(2):
        with jt as j, tt as t:
            assert (j, t) == (jt, tt)
    assert tt.time == jt.time == STEPS[1] + STEPS[3]


@pytest.mark.parametrize("fence", [
    torch.zeros(4), [torch.ones(2), (torch.ones(1),)], {"u": torch.ones(3)},
    np.ones(2), None])
def test_timer_stop_takes_cpu_tensors(clock, fence):
    """Stop accepts CPU tensors, sequences and mappings of them, and
    anything else, and waits for nothing on the CPU."""
    t = Timer("fenced").Start()
    assert t.Stop(fence) == t.time > 0


def test_timer_keeps_its_name():
    assert Timer("apply A").name == JaxTimer("apply A").name == "apply A"
    assert Timer().name == JaxTimer().name == ""
    assert Timer().time == JaxTimer().time == 0.0

"""Faults under the timed path make ``correct`` come out false.  Each test
drives a whole run (set-up, window, check) without the harness's look for a
card, with the program's unit broken underneath: a step or a solve that
returns its state unchanged (every step, or every step after the
window's first), and an answer altered where it is produced.
The cells have no batch and no exchange between chips, so those faults do
not arise.  The CPU tests run at maxh 0.6 through the program's plain
versions; the HDG solve there takes minutes, so its altered answer is
tested on the card at the cell's own size."""

import time

import numpy as np
import pytest
import torch

from perfbench import harness

SEED = 2**31 + 12345
SMALL = {"maxh": 0.6}


def _run(cell, breaker, device="cpu", overrides=SMALL, seconds=0.1,
         min_units=1):
    return harness.run(cell, SEED, seconds, False, time.perf_counter(),
                       device=device, chips_check=False,
                       overrides=overrides, breakers=breaker,
                       min_units=min_units)


def _altered(u):
    """One entry, the largest, with its sign flipped."""
    u = u.clone()
    i = int(u.abs().argmax())
    u[i] = -u[i]
    return u


def test_mcs_step_returning_its_state():
    def breaker(system):
        system._advance = lambda u: (u, [{"mstar": 1, "project": 1}])

    r = _run("mcs3d.simple", breaker)
    assert r["correct"] is False
    assert r["checks"]["step_gap"]["value"] == pytest.approx(1.0)


def test_mcs_steps_after_the_first_returning_their_state():
    """The first step of the window is sound, every later one hands back
    the state it was given (as a replay of stale buffers would)."""
    def breaker(system):
        advance = system._advance
        calls = []

        def broken(u):
            calls.append(1)
            if len(calls) == 1:
                return advance(u)
            return u, [{"mstar": 1, "project": 1}]

        system._advance = broken

    r = _run("mcs3d.simple", breaker, min_units=3)
    assert r["attempted"] == 3
    assert r["correct"] is False
    assert r["checks"]["step_gap"]["value"] == pytest.approx(1.0)


def test_mcs_step_answer_altered():
    def breaker(system):
        advance = system._advance

        def broken(u):
            v, counts = advance(u)
            return _altered(v), counts

        system._advance = broken

    r = _run("mcs3d.simple", breaker)
    assert r["correct"] is False
    for name in ("step_gap", "step_drift"):
        assert r["checks"][name]["value"] > r["checks"][name]["limit"]


def test_hdg_solve_returning_its_start_state():
    def breaker(system):
        m = system.m

        def broken():
            system.solutions.append((m.u_bc, torch.zeros_like(m.p)))
            return {"its": 0, "failed": False}

        system.run_unit = broken

    r = _run("hdg3d.stokes", breaker)
    assert r["correct"] is False
    assert r["checks"]["stokes_rel"]["value"] > 0.1


@pytest.mark.cuda
def test_hdg_solve_answer_altered_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's solve takes minutes "
                    "through the plain versions on a CPU")

    def breaker(system):
        run_unit = system.run_unit

        def broken():
            out = run_unit()
            u, p = system.solutions[-1]
            system.solutions[-1] = (_altered(u), p)
            return out

        system.run_unit = broken

    r = _run("hdg3d.stokes", breaker, device="cuda", overrides=None,
             seconds=1.0)
    assert r["correct"] is False
    rel = r["checks"]["stokes_rel"]
    assert rel["value"] > 100 * rel["limit"]
    assert np.isfinite(rel["value"])

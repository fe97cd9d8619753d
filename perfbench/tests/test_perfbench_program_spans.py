"""The readers of the program's own spans (``metrics/_program.py`` and the
seven metrics on it): the idle time put down to the innermost spans by
overlap on a hand-made trace, a program without spans read as nothing, and
a traced CPU run of ``mcs3d.simple`` at maxh 0.6 that reads the host reads
per CG iteration and no idle metric (the CPU has no device operation)."""

import sys
import time
from collections import Counter
from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.metrics import _program
from perfbench.trace import TraceSummary

IDLE_METRICS = ("cheb_idle_ms.step", "twolevel_idle_ms.step",
                "krylov_idle_ms_per_it.step")


def _span(name, start, end, parent, root, **attrs):
    return SimpleNamespace(name=name, start=start, end=end, parent=parent,
                           root=root, attrs=attrs)


def _hand_made():
    """One CG iteration: a read, then an apply.  The device runs until
    t = 100, idles while the host reads and dispatches the apply, and runs
    again from t = 300 (launched at t = 250, inside the apply)."""
    recs = [_span("step", 0, 1000, None, 0),
            _span("cg", 10, 990, 0, 0, iterations=1),
            _span("cg.read", 100, 200, 1, 0),
            _span("cg.apply", 200, 350, 1, 0),
            _span("chebyshev", 220, 340, 3, 0)]
    trace = TraceSummary(window=(0, 1000),
                         device_ops=[(0, 100, "k", 20),
                                     (300, 1000, "k", 250)],
                         syncs=Counter(cudaStreamSynchronize=1))
    return trace, recs


def test_gap_from_a_read_into_an_apply_is_split():
    trace, recs = _hand_made()
    s = _program.summarize(trace, recs, n_units=1)
    # the gap [100, 300) is shared: 100 in the read, 20 in the apply
    # before the Chebyshev apply opens, 80 inside it
    assert s["_ns"]["idle"] == {"cg.read": 100, "cg.apply": 20,
                                "chebyshev": 80}
    assert s["_ns"]["krylov_self_idle"] == 100
    assert s["covered_pct"] == 100.0
    # the second operation counts for every span open at its launch
    dev = s["_ns"]["device"]
    assert dev["chebyshev"] == dev["cg.apply"] == 700
    assert dev["cg"] == dev["step"] == 800
    assert s["reads"] == 1 and s["iterations"] == {"cg": 1}
    assert s["spans"]["cg.read"]["host_self_ms"] == pytest.approx(1e-4)
    assert s["spans"]["cg.apply"]["host_self_ms"] == pytest.approx(3e-5)

    ctx = {"trace": trace, "traced_units": [{}], "program_spans": s}
    read = {name: harness.read_metric(name, ctx) for name in (
        "cheb_idle_ms.step", "twolevel_idle_ms.step",
        "krylov_idle_ms_per_it.step", "host_reads_per_it.step")}
    assert read == {"cheb_idle_ms.step": pytest.approx(8e-5),
                    "twolevel_idle_ms.step": None,
                    "krylov_idle_ms_per_it.step": pytest.approx(1e-4),
                    "host_reads_per_it.step": 1.0}


def test_a_gap_outside_every_span_is_not_covered():
    trace, recs = _hand_made()
    trace.window = (0, 1200)
    s = _program.summarize(trace, recs, n_units=2)
    # 200 of the 400 idle ns lie after the step, under no span
    assert s["covered_pct"] == 50.0
    assert s["idle_ms"] == pytest.approx(2e-4)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """The parent of this benchmark's readers has no ``tracing`` module:
    each reader gives None and none raises."""
    import navier_stokes_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "navier_stokes_tpu_torch.utils.tracing",
                        None)
    monkeypatch.delattr(utils, "tracing", raising=False)
    trace, _ = _hand_made()
    bench = harness.load_cell("hdg3d.stokes")["per_layer"] + \
        harness.load_cell("mcs3d.simple")["per_layer"]
    new = [m["name"] for m in bench if m["source"] in
           ("program_span", "program_counter") and "its" not in m["unit"]]
    assert len(new) == 7
    for name in new:
        ctx = {"trace": trace, "traced_units": [{}]}
        assert harness.read_metric(name, ctx) is None


def test_a_window_with_spans_not_recorded_reads_nothing(monkeypatch):
    """Past the program's cap on kept spans, counts and shares would read
    low: a window that the first span not kept precedes gives None; one
    that ends before it reads as usual."""
    from navier_stokes_tpu_torch.utils import tracing

    trace, recs = _hand_made()
    monkeypatch.setattr(tracing, "records", lambda: recs)
    for first, expect_none in ((900, True), (1001, False)):
        monkeypatch.setattr(tracing, "dropped", lambda: (3, first))
        ctx = {"trace": trace, "traced_units": [{}]}
        got = harness.read_metric("host_reads_per_it.step", ctx)
        assert (got is None) is expect_none


def test_traced_cpu_run_reads_host_reads_and_no_idle():
    r = harness.run("mcs3d.simple", 2**31 + 777, 0.1, True,
                    time.perf_counter(), device="cpu", chips_check=False,
                    overrides={"maxh": 0.6})
    got = r["metrics"]
    assert r["correct"] is True
    for name in IDLE_METRICS:
        assert name not in got
    reads = got["host_reads_per_it.step"]["value"]
    its = got["cg_its_per_step"]["value"]  # over every unit of the run
    # one read per iteration and one ahead of each of the step's two CGs
    assert 1.0 < reads < 1.0 + 2.5 / its
    assert got["host_reads_per_it.step"]["unit"] == "reads"

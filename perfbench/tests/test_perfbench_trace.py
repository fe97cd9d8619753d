"""The traced window records the harness's own spans and none of the
program's ``aten`` ops, so tracing adds little to each host launch; the
reduction finds the window and the spans in what it recorded."""

import torch
from torch.profiler import record_function

from perfbench.harness import lean_profiler
from perfbench.trace import reduce_events


def test_lean_profiler_keeps_spans_and_drops_ops():
    prof = lean_profiler(on_cuda=False)
    with record_function("pb:window"):
        x = torch.ones(8)
        for _ in range(3):
            with record_function("pb:unit"):
                x = x + 1
    prof.stop()
    events = list(prof.profiler.kineto_results.events())
    names = [ev.name() for ev in events]
    assert not [n for n in names if n.startswith("aten::")]
    summary = reduce_events(events)
    assert summary.window_s > 0
    assert len(summary.spans["pb:unit"]) == 3
    assert summary.device_ops == []


def test_traced_units_run_after_the_window():
    """A traced run on the CPU at maxh 0.6: the window's units run
    untraced, ``trace_units`` more run under the profiler after it, and
    the per-layer metrics that the CPU can give are read."""
    import time

    from perfbench import harness

    r = harness.run("mcs3d.simple", 2**31 + 4321, 0.1, True,
                    time.perf_counter(), device="cpu", chips_check=False,
                    overrides={"maxh": 0.6})
    cell = harness.load_cell("mcs3d.simple")
    assert r["attempted"] >= 1 + cell["traffic"]["trace_units"]
    assert r["correct"] is True
    assert r["metrics"]["cg_its_per_step"]["value"] > 0
    assert "step_ms" not in r["metrics"]
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}

"""BENCHMARK.json against the benchmark's contract, and the keys of a
run's last line."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def _named():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield key, entry


@pytest.mark.parametrize("key,entry", list(_named()),
                         ids=lambda v: v if isinstance(v, str) else v["name"])
def test_names_units_and_keys(key, entry):
    assert NAME.match(entry["name"])
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }[key]
    assert set(entry) <= allowed
    if key in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    if key == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if key == "per_layer":
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        e2e = {m["name"] for m in BENCH["end_to_end"]}
        assert entry["moves"] in e2e
        if entry["name"].endswith("_roofline") or "_roofline." in \
                entry["name"]:
            assert entry["unit"] == "%"
    if key == "workloads":
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] in (1, 4)
        assert 1 <= len(entry["why"]) <= 200
    if key == "configs":
        assert (REPO / entry["file"]).is_file()
        assert entry["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in entry["reduced"])


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in BENCH["workloads"]:
        name = cell["name"]

        def reports(m):
            return name in m.get("workloads", [name])

        e2e = [m["name"] for m in BENCH["end_to_end"] if reports(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(m) for m in BENCH["per_layer"])
        # each per-layer metric's end-to-end metric is reported there
        for m in BENCH["per_layer"]:
            if reports(m):
                assert m["moves"] in e2e


def test_cells_and_metrics_of_this_benchmark():
    cells = {c["name"]: c for c in BENCH["workloads"]}
    assert set(cells) == {"mcs3d.simple", "hdg3d.stokes"}
    assert all(c["chips"] == 1 for c in cells.values())
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "setup_s", "step_ms", "solve_s"}
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"Krylov", "driver / host dispatch", "preconditioner",
                      "kernels", "device", "whole unit"}


def test_result_line_keys():
    """The last line's keys, as the harness builds them (a stand-in result
    with the keys a CPU run gives; the CPU runs of the other tests print
    the real ones)."""
    line = harness.result_line(
        correct=True, attempted=3, failed=0,
        metrics={"step_ms": {"value": 1.0, "unit": "ms"}},
        device={"platform": "gpu", "kind": "k", "count": 1,
                "memory_peak_bytes": 1},
        checks=[("step_gap", 0.1, 1.0)])
    keys = list(json.loads(json.dumps(line)))
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"

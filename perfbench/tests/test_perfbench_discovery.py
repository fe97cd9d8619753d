"""The harness finds configurations, traffic mixes and per-layer metrics by
name: a new one is new files and new BENCHMARK.json entries, with no file
that is there edited."""

import json
import shutil
import sys
from pathlib import Path

import pytest

from perfbench import harness

REPO = Path(__file__).resolve().parents[2]


def test_each_cell_finds_its_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        found = harness.load_cell(cell["name"])
        assert found["spec"]["name"] == cell["config"]
        assert callable(found["module"].System)
        assert callable(found["module"].check)
        assert found["traffic"]["op"]
        for m in found["per_layer"]:
            assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py"
                    ).is_file()


@pytest.fixture
def copy_of_benchmark(tmp_path, monkeypatch):
    """The benchmark's files (BENCHMARK.json and perfbench/) copied into a
    directory of their own, imported from there."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    saved = {k: v for k, v in sys.modules.items()
             if k == "perfbench" or k.startswith("perfbench.")}
    for k in saved:
        del sys.modules[k]
    monkeypatch.syspath_prepend(str(tmp_path))
    import perfbench.harness as copied
    assert Path(copied.__file__).parent == tmp_path / "perfbench"
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    yield tmp_path, copied, before
    for k in [k for k in sys.modules
              if k == "perfbench" or k.startswith("perfbench.")]:
        del sys.modules[k]
    sys.modules.update(saved)


def test_a_new_metric_config_and_mix_are_new_files(copy_of_benchmark):
    root, copied, before = copy_of_benchmark
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # a new per-layer metric: its reader and its entry
    (root / "perfbench" / "metrics" / "units_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx['units']))\n")
    bench["per_layer"].append({
        "name": "units_seen", "unit": "units", "better": "higher",
        "source": "program_counter", "layer": "Krylov", "moves": "solve_s",
        "workloads": ["hdg3d.stokes", "toy.stokes"]})
    # a new configuration and a new mix: data and a configuration module
    cfg = json.loads((root / "perfbench" / "configs" /
                      "hdg3d-cyl-h0.09.json").read_text())
    cfg["name"], cfg["maxh"] = "toy-cfg", 0.6
    (root / "perfbench" / "configs" / "toy-cfg.json").write_text(
        json.dumps(cfg))
    shutil.copy(root / "perfbench" / "configs" / "hdg3d-cyl-h0.09.py",
                root / "perfbench" / "configs" / "toy-cfg.py")
    mix = json.loads((root / "perfbench" / "traffic" / "stokes.json")
                     .read_text())
    mix["params"]["tol"] = 1e-6
    (root / "perfbench" / "traffic" / "loose.json").write_text(
        json.dumps(mix))
    bench["configs"].append({"name": "toy-cfg", "source": "a test",
                             "file": "perfbench/configs/toy-cfg.json",
                             "reduced": ["maxh"], "why": "a test"})
    bench["workloads"].append({"name": "toy.stokes", "config": "toy-cfg",
                               "traffic": "loose", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][[m["name"] for m in bench["end_to_end"]]
                        .index("solve_s")]["workloads"].append("toy.stokes")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = copied.load_cell("hdg3d.stokes")
    assert "units_seen" in [m["name"] for m in cell["per_layer"]]
    assert copied.read_metric("units_seen", {"units": [{}, {}]}) == 2.0
    toy = copied.load_cell("toy.stokes")
    assert toy["spec"]["maxh"] == 0.6
    assert toy["traffic"]["params"]["tol"] == 1e-6
    assert [m["name"] for m in toy["end_to_end"]] == ["setup_s", "solve_s"]
    assert [m["name"] for m in toy["per_layer"]] == ["units_seen"]
    # no file that was there changed, but BENCHMARK.json
    for path, data in before.items():
        if path.name != "BENCHMARK.json":
            assert path.read_bytes() == data, path


def test_a_run_refuses_without_its_files(tmp_path, monkeypatch):
    """In a directory that holds only BENCHMARK.json and perfbench/, the
    program is missing: the run prints no result and exits non-zero."""
    import subprocess

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "hdg3d.stokes",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_run_refuses_without_a_card():
    """No CUDA device here: the run prints no result and exits non-zero."""
    import subprocess

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "hdg3d.stokes",
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr

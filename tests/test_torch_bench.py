"""The port's bench line (``navier_stokes_tpu_torch.bench``) on the CPU.

The bench configuration itself (the curved channel at maxh = 0.09) runs on
the card, in ``chip_smoke.py``'s ``[bench]`` phase.  One curved GS flagship
solve at maxh = 0.6 takes minutes on one CPU thread, so :func:`measure`
runs here end to end -- a cold and a warm ``FlagshipSolve.full_solve`` and
timed ``transient_steps`` -- on the 24-tet Poiseuille-between-plates models
(float64 and its float32 twin), and the line's parts are checked on their
own:

* the key set is bench.py's, in one JSON line;
* ``vs_baseline`` and ``steps_vs_baseline`` divide by the numbers recorded
  in ``BASELINE_CPU.json`` (54.207 s; 0.006509 steps/s), read and not
  re-measured: another file gives other ratios, and a file for another
  configuration, or one without a number, is refused;
* the iteration budget (460 inner iterations) and the true f64 residual
  (1.01e-8) raise when missed;
* the module refuses to run without a CUDA device and prints no line.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.mesh.generators import extrude_to_tets, rectangle_mesh
from navier_stokes_tpu_torch import bench
from navier_stokes_tpu_torch.flagship import FlagshipResult
from navier_stokes_tpu_torch.mesh.mesh import Mesh
from navier_stokes_tpu_torch.models import NavierStokesMCS

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for PyTorch and one for numpy's BLAS: the
    suite runs several workers at once, and a thread pool per worker
    beside them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _plates_uin(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = p[:, 1] * (1.0 - p[:, 1])
    return out


@pytest.fixture(scope="module")
def plates(one_torch_thread):
    base = rectangle_mesh(0.5, 1.0, 1.0)
    jmesh = extrude_to_tets(base, np.linspace(0, 0.5, 2))
    jmesh.tag_boundary_by_predicate(
        "outlet", lambda p: np.abs(p[:, :, 0] - 1.0) < 1e-9)
    rest = np.setdiff1d(jmesh.boundary_facets, jmesh.boundary_tags["outlet"])
    jmesh.boundary_tags["diri"] = rest.astype(np.int32)
    mesh = Mesh(jmesh.points.copy(), jmesh.elements.copy(),
                {k: np.asarray(v).copy()
                 for k, v in jmesh.boundary_tags.items()})
    kw = dict(nu=1.0, inflow="diri", outflow="outlet", wall="",
              uin=_plates_uin, timestep=1e-3, order=2, device="cpu")
    cache = {}
    m = NavierStokesMCS(mesh, assembly_cache=cache, **kw)
    m32 = NavierStokesMCS(mesh, assembly_cache=cache, dtype=torch.float32,
                          **kw)
    return m, m32


def _result(inner=400, true_rel=9e-9):
    return FlagshipResult(x=None, rel=true_rel, true_rel=true_rel,
                          inner=inner, seconds=2.0)


def test_measure_end_to_end_on_the_plates(plates):
    m, m32 = plates
    line, info = bench.measure(m, m32, n_steps=3, card=CARD)
    assert tuple(line) == bench.KEYS
    text = json.dumps(line)
    assert "\n" not in text and json.loads(text) == line
    warm = info["warm"]
    assert warm.true_rel <= 1.01e-8 and warm.inner == info["cold"].inner
    assert line["value"] == round(warm.inner / warm.seconds, 2)
    assert line["vs_baseline"] == round(54.207 / warm.seconds, 3)
    sps = info["n_steps"] / info["step_seconds"]
    assert info["n_steps"] == 3 and len(info["step_counts"]) == 3
    assert line["steps_per_sec"] == float(f"{sps:.4g}")
    assert line["steps_vs_baseline"] == round(sps / 0.006509, 3)
    assert CARD in line["unit"] and bench.CONFIG in line["unit"]
    assert "BASELINE_CPU.json" in line["unit"]
    assert "not re-measured" in line["unit"]
    # the iteration budget of bench.py's configuration holds the solve
    with pytest.raises(RuntimeError, match="budget"):
        bench.measure(m, m32, n_steps=3, card=CARD,
                      max_inner=warm.inner - 1)


def test_measure_takes_results_already_solved(plates, monkeypatch):
    """Given the cold and warm results, ``measure`` solves nothing again:
    it checks them and times the steps."""
    m, m32 = plates

    def no_solve(*a, **k):
        raise AssertionError("measure solved again")

    monkeypatch.setattr(bench, "FlagshipSolve", no_solve)
    cold, warm = _result(410, 9e-9), _result(400, 8e-9)
    line, info = bench.measure(m, m32, cold=cold, warm=warm, n_steps=3,
                               card=CARD)
    assert info["cold"] is cold and info["warm"] is warm
    assert line["value"] == 200.0 and info["n_steps"] == 3
    assert line["vs_baseline"] == round(54.207 / 2.0, 3)
    with pytest.raises(RuntimeError, match="budget"):
        bench.measure(m, m32, cold=cold, warm=_result(461), n_steps=3,
                      card=CARD)
    with pytest.raises(ValueError, match="both"):
        bench.measure(m, m32, warm=warm, n_steps=3, card=CARD)


def test_bench_line_divides_by_the_recorded_baseline():
    art = bench.load_baseline()
    assert art["solve_wall_s"] == 54.207 and art["solve_inner"] == 408
    assert art["transient_steps_per_sec"] == 0.006509
    line = bench.bench_line(400, 2.0, 5.0, art, CARD)
    assert set(line) == set(bench.KEYS)
    assert line["metric"] == "mcs3d_initial_stokes_to_residual_1e-8"
    assert line["value"] == 200.0
    assert line["vs_baseline"] == round(54.207 / 2.0, 3)
    assert line["steps_per_sec"] == 5.0
    assert line["steps_vs_baseline"] == round(5.0 / 0.006509, 3)
    assert "3D MCS channel maxh=0.09" in line["unit"]
    assert "54.207s" in line["unit"] and CARD in line["unit"]


def test_baseline_is_read_not_measured(tmp_path):
    art = json.load(open(os.path.join(ROOT, "BASELINE_CPU.json")))
    art = dict(art, solve_wall_s=10.0, transient_steps_per_sec=0.5)
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(art))
    line = bench.bench_line(400, 2.0, 5.0, bench.load_baseline(str(path)),
                            CARD)
    assert line["vs_baseline"] == 5.0 and line["steps_vs_baseline"] == 10.0
    path.write_text(json.dumps(dict(art, config=dict(art["config"],
                                                     maxh=0.3))))
    with pytest.raises(ValueError, match="baseline of"):
        bench.load_baseline(str(path))
    path.write_text(json.dumps(dict(art, transient_steps_per_sec=None)))
    with pytest.raises(ValueError, match="transient_steps_per_sec"):
        bench.load_baseline(str(path))
    with pytest.raises(FileNotFoundError):
        bench.load_baseline(str(tmp_path / "missing.json"))


@pytest.mark.parametrize("inner,true_rel,ok", [
    (460, 1.01e-8, True), (461, 9e-9, False), (100, 1.02e-8, False),
    (10_000, 1e-9, None)])
def test_check_solve_holds_budget_and_residual(inner, true_rel, ok):
    if ok is None:  # no budget
        bench.check_solve(_result(inner, true_rel), "solve", max_inner=None)
        return
    if ok:
        bench.check_solve(_result(inner, true_rel), "solve")
    else:
        with pytest.raises(RuntimeError):
            bench.check_solve(_result(inner, true_rel), "solve")


def test_module_refuses_without_a_card():
    """No CPU fallback: without CUDA the module exits non-zero and prints
    nothing on standard output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the module would measure")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m",
                          "navier_stokes_tpu_torch.bench"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr

"""Parity of the port's parameter-sweep harness
(``navier_stokes_tpu_torch.scripts.run_ns_sweep``) with the JAX package's
``scripts/run_ns_sweep.py`` (the reference's
templates/run_navier_stokes_parameter_sweep.py).

``solve`` at h = 1.0, order 2, Gauss-Seidel on and off, with one model
kept across both settings in each package: the port's solve is given the
JAX model's Bramble-Pasciak k, and its BPCG count must equal JAX's, or
differ by one where the two error histories straddle the stopping
threshold (1e-10) at the smaller count, each within a factor 1.5 of it.
``main`` writes the JAX package's CSV schema (the repository's data.csv
header, an index column, ``True``/``False``) and returns its rows; the
default grid is the JAX script's (12 solves of the MCS model).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.solvers.bpcg import bp_scale_factor as jax_bp_scale
from navier_stokes_tpu_torch.scripts import run_ns_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-10


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_run_ns_sweep", os.path.join(ROOT, "scripts", "run_ns_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


@pytest.fixture(scope="module")
def caches():
    return {"jax": _jax_script(), "jc": {}, "pc": {}}


@pytest.mark.parametrize("gs", [True, False])
def test_solve_rows_match_jax(caches, gs):
    jr, jc, pc = caches["jax"], caches["jc"], caches["pc"]
    h, order = 1.0, 2
    n_jax, t_jax = jr.solve(h, order, gs, jc, True)
    mj = jc[(h, order)]
    f_mod = jnp.where(mj.free, mj.f - mj.A_raw(mj.u_bc), 0.0)
    k = float(jax_bp_scale(mj.A, mj._preA_for(gs), f_mod)[0])
    res = []
    n_port, t_port = run_ns_sweep.solve(h, order, gs, pc, True, device="cpu",
                                        scale_k=k, result=res)
    assert list(pc) == [(h, order)]  # one model for both GS settings
    assert pc[(h, order)].stokes_bpcg_scale_k == k
    assert n_port == res[0].iterations and res[0].converged
    assert t_port > 0 and t_jax > 0
    if n_port != n_jax:
        n = min(n_port, n_jax)
        rj = mj.SolveInitial(iterative=True, GS=gs, tol=TOL)  # its errors
        ej = float(np.asarray(rj.errors)[n])
        ep = float(res[0].errors[n])
        assert abs(n_port - n_jax) == 1, (n_port, n_jax)
        lo, hi = sorted((ej, ep))
        assert TOL / 1.5 <= lo < TOL <= hi <= 1.5 * TOL, (n_port, n_jax)


def test_main_writes_the_jax_schema(tmp_path, monkeypatch):
    assert run_ns_sweep.grid(False, True) == ([0.125, 0.25, 0.5], [3, 2])
    assert run_ns_sweep.grid(False, False) == ([0.125, 0.25, 0.5],
                                               [4, 3, 2])
    assert run_ns_sweep.grid(True, True) == (
        [1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125], [2, 3, 4, 5, 6, 7])
    monkeypatch.setattr(run_ns_sweep, "grid", lambda full, mcs: ([1.0], [2]))
    out = str(tmp_path / "data.csv")
    rows = run_ns_sweep.main(["--cpu", "--out", out])
    assert [(r["mesh_size"], r["order"], r["gauss_seidel_enabled"])
            for r in rows] == [(1.0, 2, True), (1.0, 2, False)]
    with open(out) as fh, open(os.path.join(ROOT, "data.csv")) as ref:
        lines = fh.read().splitlines()
        ref_lines = ref.read().splitlines()
    assert lines[0] == ref_lines[0]
    assert len(lines) == 3
    for i, (line, row) in enumerate(zip(lines[1:], rows)):
        cells = line.split(",")
        assert cells[0] == str(i)
        assert cells[1:3] == ref_lines[1 + i].split(",")[1:3]  # 1.0, 2
        assert int(cells[3]) == row["iterations"] > 0
        assert float(cells[4]) == row["time"] > 0
        assert cells[5] == ref_lines[1 + i].split(",")[5]  # True, False


def test_main_writes_under_build_by_default(tmp_path, monkeypatch):
    """Without ``--out`` the CSV goes to build/ns_sweep/data.csv under the
    working directory, never to a data.csv beside it (run from the
    repository's root that is the JAX package's record)."""
    monkeypatch.setattr(run_ns_sweep, "grid", lambda full, mcs: ([1.0], [2]))
    monkeypatch.chdir(tmp_path)
    rows = run_ns_sweep.main(["--cpu"])
    assert not (tmp_path / "data.csv").exists()
    lines = (tmp_path / "build" / "ns_sweep" / "data.csv").read_text()
    assert len(lines.splitlines()) == len(rows) + 1 == 3

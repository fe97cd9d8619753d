"""The port's attribution scripts ``microbench_sweep`` and ``audit_tables``
(navier_stokes_tpu_torch/scripts/) with ``device="cpu"`` on the curved
flagship configuration at maxh 0.6 (``build_model(0.6)``,
``FlagshipSolve``: bench.py's settings), where every wrapper takes its
plain version and no time is taken:

* microbench_sweep: one row per JAX piece name, in the JAX script's order
  (scripts/microbench_sweep.py:17-26), then one per GS color; every piece
  finite (the script raises otherwise); its ``pre_skel`` piece is the
  preconditioner's own ``parts["pre_skel"]`` (equal outputs);
* audit_tables: the JAX script's six table rows, their total and the
  edge-star size histogram equal, line for line, what
  ``scripts/audit_tables.main`` prints at 0.6 (run here, its stdout
  captured); the port's GS solve tables by segment are fewer bytes than
  the padded layout they stand for, and every table of the preconditioner
  has a stream count.

``probe_transient`` is tested in tests/test_torch_probe_transient.py.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu_torch.flagship import FlagshipSolve, build_model
from navier_stokes_tpu_torch.scripts import audit_tables, microbench_sweep

MAXH = 0.6
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


@pytest.fixture(scope="module")
def solver(one_torch_thread):
    return FlagshipSolve(build_model(MAXH, device="cpu"))


def test_microbench_sweep_pieces(solver):
    rows = microbench_sweep.main(MAXH, device="cpu", solver=solver)
    names = [r["piece"] for r in rows]
    assert tuple(names[:8]) == microbench_sweep.PIECES == (
        "preA", "pre_skel", "fwd_sweep", "one_color", "P_only",
        "solve_only", "S_faces", "coarse")
    ncolors = len(solver.ops32["preA"].parts["groups"])
    assert names[8:] == [f"color {c}" for c in range(ncolors)]
    assert all(r["replay_ms"] is None for r in rows)  # no time on the CPU


def test_microbench_sweep_pre_skel_is_the_preconditioner_s(solver):
    preA = solver.ops32["preA"]
    probes = {name: (fn, x) for name, fn, x in
              microbench_sweep.pieces(preA, solver.m.n)}
    fn, x = probes["pre_skel"]
    y = fn(x)
    assert torch.isfinite(y).all()
    assert torch.equal(y, preA.parts["pre_skel"](x))
    fn, u = probes["preA"]
    assert torch.equal(fn(u), preA(u))


def _jax_audit_lines(monkeypatch, capsys):
    """scripts/audit_tables.main at MAXH, its stdout's lines."""
    for key, val in (("BENCH_CPU", "1"), ("NSTPU_SMOOTHER_BF16", "ext,inv"),
                     ("NSTPU_COARSE_TARGET", "1.6")):
        monkeypatch.setenv(key, val)  # undone after the test
    monkeypatch.setattr(sys, "argv", ["audit_tables.py", str(MAXH)])
    spec = importlib.util.spec_from_file_location(
        "jax_audit_tables", os.path.join(ROOT, "scripts", "audit_tables.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


def test_audit_tables_matches_the_jax_script(solver, monkeypatch, capsys):
    want = _jax_audit_lines(monkeypatch, capsys)
    out = audit_tables.main(MAXH, device="cpu", solver=solver)
    got = capsys.readouterr().out.splitlines()
    start = next(i for i, s in enumerate(want) if s.startswith("maxh="))
    end = next(i for i, s in enumerate(want)
               if s.startswith("edge-star size histogram"))
    jax_block = want[start: end + 1]
    assert len(jax_block) == 12  # header, blank, titles, 6 rows, total, ...
    assert got[: len(jax_block)] == jax_block
    assert "\n".join(out["jax_lines"]).splitlines() == jax_block
    assert out["launches"] is None  # no kernel on the CPU


def test_audit_tables_port_rows(solver):
    out = audit_tables.main(MAXH, device="cpu", solver=solver)
    preA = solver.ops32["preA"]
    names = [t[0] for t in out["tables"]]
    assert names[: len(preA.parts["tables"])] == list(preA.parts["tables"])
    ncolors = len(preA.parts["groups"])
    streams = dict((t[0], t[3]) for t in out["tables"])
    # the launches one preA apply makes: 5 single tables, S, 2C-1 panel
    # and 2C solve streams
    assert sum(streams[n] for n in preA.parts["tables"]) == 6 + 4 * ncolors - 1
    solves = [t for n, t in preA.parts["tables"].items()
              if n.endswith(" solve")]
    real = sum(t.real_bytes for t in solves)
    padded = sum(t.nblk * t.width ** 2 * t.data.element_size()
                 for t in solves)
    assert 0 < real < padded
    assert np.isfinite(out["bound_ms"]) and out["bound_ms"] > 0

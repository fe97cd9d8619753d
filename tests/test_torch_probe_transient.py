"""The port's ``probe_transient`` script
(navier_stokes_tpu_torch/scripts/probe_transient.py) with
``device="cpu"`` on the f32 stepping model at maxh 0.6 (straight: the
curved tables add seconds and no piece): its rows
carry the JAX script's piece names in the JAX script's order
(scripts/probe_transient.py:70-138), every piece is finite (the script
raises otherwise), no time is taken, and the standalone M* and projection
CG counts equal the model's ``last_iterations`` after one step from the
same state (94 and 78 here) -- the step runs the same two solves.  Its own
file: the two CG solves and the step take most of a minute on one thread.
"""

import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu_torch.flagship import build_model
from navier_stokes_tpu_torch.scripts import probe_transient

MAXH = 0.6
JAX_PIECES = ["rhs = conv+f-A_raw", "conv alone", "A_raw alone",
              "mstar CG (tol 1e-4)", "Minv (cheb deg16)", "B_raw", "BT",
              "S apply (B Minv BT)", "twolevel pre",
              "projection CG (tol 1e-5)", "FUSED STEP", "in-step counts"]


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
def rows(one_torch_thread):
    m = build_model(MAXH, device="cpu", dtype=torch.float32, curved=False)
    return m, probe_transient.main(MAXH, device="cpu", m=m)


def test_jax_piece_names_in_order(rows):
    names = [r["piece"] for r in rows[1]]
    assert names[: len(JAX_PIECES)] == JAX_PIECES
    assert names[len(JAX_PIECES):] == ["mass_raw", "mstar apply",
                                       "twolevel block"]
    for r in rows[1]:
        assert r.get("replay_ms") is None and r.get("host_ms") is None


def test_cg_counts_equal_the_steps(rows):
    m, out = rows
    by = {r["piece"]: r for r in out}
    counts = by["in-step counts"]
    assert by["mstar CG (tol 1e-4)"]["iterations"] == counts["mstar"]
    assert by["projection CG (tol 1e-5)"]["iterations"] == counts["project"]
    assert counts == {"piece": "in-step counts",
                      "mstar": m.last_iterations["mstar"],
                      "project": m.last_iterations["project"]}
    assert by["mstar CG (tol 1e-4)"]["converged"]
    assert by["projection CG (tol 1e-5)"]["converged"]
    assert by["projection CG (tol 1e-5)"]["err0"] > 0

"""The port's entry points (``navier_stokes_tpu_torch.graft_entry``)
against ``__graft_entry__.py``, on the CPU.

* ``entry(device="cpu")``: the 2D MCS model at maxh 0.25 in float32, one
  step of its ``make_step_fn()`` (kernel 8's plain version on the CPU)
  against one step of ``__graft_entry__.entry()`` run by ``jax.jit`` from
  the same state: within ``STEP_BOUND`` = 1e-6 of max |u| (float32
  roundoff: the two packages sum the element products and the Krylov dots
  in different orders; each model takes the Chebyshev bounds of its mass
  inverse from its own Lanczos run, as ``entry()`` does in both);
* the data-parallel half of ``dryrun_multichip``
  (``data_parallel_half``) on 2 gloo ranks (one torch and one BLAS thread
  each): the batch of Taylor-Hood float32 steps at maxh 0.25 has JAX's
  shape (ranks, V.ndof), every row ``torch.equal`` to the unsharded step
  of the same model in this process, and within ``STEP_BOUND`` of the
  JAX model's jitted step (``__graft_entry__._make_model(0.25)``) given
  the port model's Chebyshev bounds of the mass inverse (the JAX model's
  own Lanczos starts from a random vector, and its bounds alone move the
  step by more than ``STEP_BOUND``).

The spatial half (the face-sharded solve) is held to the JAX package by
tests/test_torch_faceshard_solve.py at maxh 0.6 and, at the dry run's
maxh 0.35 and tolerance 1e-8, by ``chip_smoke.py`` ``[graft]`` on the card.
"""

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import __graft_entry__ as jax_entry
from navier_stokes_tpu.precond.chebyshev import (
    chebyshev_preconditioner as jax_chebyshev,
)
from navier_stokes_tpu_torch import graft_entry
from navier_stokes_tpu_torch.parallel.sharding import Ranks

STEP_BOUND = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _close(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(got - want).max() <= STEP_BOUND * np.abs(want).max()


def test_entry_step_matches_jax():
    fn, (u,) = graft_entry.entry(device="cpu")
    jfn, (ju,) = jax_entry.entry()
    assert u.dtype == torch.float32 and u.shape == tuple(ju.shape)
    assert np.array_equal(u.numpy(), np.asarray(ju))
    got = fn(u)
    want = np.asarray(jax.jit(jfn)(ju))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert np.abs(want - np.asarray(ju)).max() > 0.1  # the step moves u
    assert _close(got.numpy(), want)


def test_entry_main_runs_one_step(capsys):
    assert graft_entry.main(["--device", "cpu"]) == 0
    assert "entry() compile+run OK, out shape" in capsys.readouterr().out


def test_data_parallel_half_on_two_ranks():
    out = graft_entry.data_parallel_half(Ranks(2, device="cpu", threads=1))
    batch = out["out"]
    model = graft_entry._make_model(graft_entry.ENTRY_MAXH, device="cpu")
    assert tuple(batch.shape) == (2, model.V.ndof)
    want = model.make_step_fn()(model.u)
    for row in batch:
        assert torch.equal(row, want)
    jm = jax_entry._make_model(maxh=graft_entry.ENTRY_MAXH)
    assert np.array_equal(model.u.numpy(), np.asarray(jm.u))
    # the port's Chebyshev bounds in the JAX model (its own Lanczos starts
    # from PRNGKey(0)): the same polynomial approximates M^-1 in both
    jm._mass_cheb = jax_chebyshev(jm.Mv, jm.preMv, jm.u_bc.reshape(-1),
                                  degree=16,
                                  bounds=model._mass_chebyshev().bounds)
    jax_step = np.asarray(jax.jit(jm.make_step_fn())(jm.u))
    assert _close(want.numpy(), jax_step)
    assert set(out["iterations"]) == {"mstar", "project"}

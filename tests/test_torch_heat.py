"""Parity of the port's heat model and time integrators
(navier_stokes_tpu_torch ``models.heat``, ``timestepping``,
``linalg.dense``) with the JAX package.

Both packages build ``HeatEquation`` on the unit square at maxh 0.3 with
order 4 and 6 (the reference runs order 10 at maxh 0.1: chip_smoke.py
``[heat]``) and advance the reference's initial condition by a few large
steps; the port on the CPU, where its wrappers take the kernels' plain
versions.  Random inputs come from numpy generators with fixed seeds.
Tolerances:

* Gauss IRK weights: 1e-14; ``orthonormalize``: 1e-12; a dense solve and
  an IRK step: 1e-12 (relative);
* host tables (element mass and stiffness, the initial state): 1e-13
  (relative to the largest entry);
* the state after n steps: 1e-10 (relative, 2-norm); L2 errors: 1e-8
  (relative);
* the convergence study's CSV: the same header and time steps, errors
  within 1e-8.
"""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mcs2d_solve import (
    _rel,
    one_torch_thread,  # noqa: F401  (the module's thread limits)
)

from navier_stokes_tpu.linalg.dense import dense_solve as jax_dense_solve
from navier_stokes_tpu.models import heat as jheat
from navier_stokes_tpu.timestepping import exponential as jexp
from navier_stokes_tpu.timestepping import orthonormalization as jorth
from navier_stokes_tpu.timestepping import runge_kutta as jrk
from navier_stokes_tpu_torch.linalg.dense import dense_solve
from navier_stokes_tpu_torch.models import heat as theat
from navier_stokes_tpu_torch.timestepping import (
    implicit_runge_kutta_weights,
    krylov_exponential_step,
    linear_implicit_runge_kutta_step,
    orthonormalize,
)

MAXH = 0.3
KL = theat.DEFAULT_KL


@pytest.mark.parametrize("stages", [1, 2, 3, 5, 10])
def test_irk_weights_match_jax(stages):
    wj = jrk.implicit_runge_kutta_weights(stages)
    wt = implicit_runge_kutta_weights(stages)
    assert wt.stages == stages
    for a, b in ((wj.a, wt.a), (wj.b, wt.b), (wj.c, wt.c)):
        assert np.abs(a - b).max() <= 1e-14


def test_irk_step_and_dense_solve_match_jax():
    rng = np.random.default_rng(31)
    M = -np.eye(5) * 3.0 + 0.3 * rng.standard_normal((5, 5))
    y = rng.standard_normal(5)
    w = jrk.implicit_runge_kutta_weights(10)
    yj = jrk.linear_implicit_runge_kutta_step(w, jnp.asarray(M),
                                              jnp.asarray(y), 0.05)
    yt = linear_implicit_runge_kutta_step(
        implicit_runge_kutta_weights(10), torch.from_numpy(M),
        torch.from_numpy(y), 0.05)
    assert _rel(yj, yt.numpy()) <= 1e-12
    A = rng.standard_normal((7, 7)) + 7 * np.eye(7)
    B = rng.standard_normal((7, 3))
    assert _rel(jax_dense_solve(jnp.asarray(A), jnp.asarray(B)),
                dense_solve(torch.from_numpy(A), torch.from_numpy(B)).numpy()
                ) <= 1e-12


def test_orthonormalize_matches_jax():
    X = np.random.default_rng(32).standard_normal((5, 300))
    Qj = np.asarray(jorth.orthonormalize(jnp.asarray(X), tries=3))
    Qt = orthonormalize(torch.from_numpy(X), tries=3).numpy()
    assert np.abs(Qj - Qt).max() <= 1e-12
    assert np.abs(Qt @ Qt.T - np.eye(5)).max() <= 1e-12


@pytest.fixture(scope="module", params=[4, 6])
def models(request):
    kw = dict(maxh=MAXH, order=request.param)
    return jheat.HeatEquation(**kw), theat.HeatEquation(device="cpu", **kw)


def test_heat_tables_match_jax(models):
    mj, mt = models
    assert mj.ndof == mt.ndof
    np.testing.assert_array_equal(np.asarray(mj.free), mt.free.numpy())
    for a, b in ((mj.mass_local, mt.mass_local),
                 (mj.stiff_local, mt.stiff_local)):
        a, b = np.asarray(a), b.numpy()
        assert np.abs(a - b).max() <= 1e-13 * np.abs(a).max()
    ic = theat.sum_of_unit_square_laplace_eigenfunctions(KL)
    assert _rel(mj.set_initial(ic), mt.set_initial(ic).numpy()) <= 1e-13


def test_krylov_step_matches_jax(models):
    """One large step from the initial state through both packages'
    ``krylov_exponential_step`` (the models' own operators and solves)."""
    mj, mt = models
    ic = theat.sum_of_unit_square_laplace_eigenfunctions(KL)
    _, sj = mj._heat_ops(0.01 / 5)
    _, st_ = mt._heat_ops(0.01 / 5)
    Tj = jexp.krylov_exponential_step(mj.set_initial(ic), mj._apply_stiff,
                                      mj._apply_mass, sj, mj.weights, 0.01, 5)
    mt.cg_iterations = []
    Tt = krylov_exponential_step(mt.set_initial(ic), mt._apply_stiff,
                                 mt._apply_mass, st_, mt.weights, 0.01, 5)
    assert _rel(Tj, Tt.numpy()) <= 1e-10
    assert len(mt.cg_iterations) == 4 and min(mt.cg_iterations) > 0


@pytest.mark.parametrize("dt", [0.05, 0.0125])
def test_heat_solve_matches_jax(models, dt):
    """``solve`` to t = 0.05 (1 and 4 steps): states within 1e-10, L2
    errors within 1e-8; every inner CG converges below maxsteps."""
    mj, mt = models
    ic = theat.sum_of_unit_square_laplace_eigenfunctions(KL)
    Tj, fj = mj.solve(ic, 0.05, dt)
    Tt, ft = mt.solve(ic, 0.05, dt)
    assert fj == ft
    assert _rel(Tj, Tt.numpy()) <= 1e-10
    ej = mj.l2_error(Tj, jheat.exact_solution(KL, fj))
    et = mt.l2_error(Tt, theat.exact_solution(KL, ft))
    assert abs(et - ej) <= 1e-8 * ej
    n = round(0.05 / dt)
    assert len(mt.step_seconds) == n and len(mt.cg_iterations) == 4 * n
    assert max(mt.cg_iterations) < mt.inner_maxsteps


def _read_csv(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def test_convergence_study_csv_matches_jax(tmp_path):
    ts = [0.05, 0.025]
    fj, ft = tmp_path / "jax.csv", tmp_path / "port.csv"
    jheat.heat_convergence_study(time_steps=ts, data_file=str(fj),
                                 maxh=MAXH, order=4)
    rows = theat.heat_convergence_study(time_steps=ts, data_file=str(ft),
                                        maxh=MAXH, order=4, device="cpu")
    a, b = _read_csv(fj), _read_csv(ft)
    assert a[0] == b[0] == ["", "time_step", "error"]
    assert len(a) == len(b) == len(rows) + 1 == 3
    for ra, rb, row in zip(a[1:], b[1:], rows):
        assert ra[:2] == rb[:2]
        assert abs(float(ra[2]) - float(rb[2])) <= 1e-8 * float(ra[2])
        assert float(rb[2]) == row["error"]


def test_run_heat_script_quick(tmp_path, capsys):
    """``python -m navier_stokes_tpu_torch.scripts.run_heat -q`` on the
    CPU: seven rows, errors falling with the step."""
    from navier_stokes_tpu_torch.scripts import run_heat

    out = tmp_path / "heat_errors.csv"
    assert run_heat.main(["-q", str(out), "--device", "cpu"]) == 0
    rows = _read_csv(out)
    assert rows[0] == ["", "time_step", "error"] and len(rows) == 8
    errs = [float(r[2]) for r in rows[1:]]
    assert all(np.isfinite(errs)) and errs[-1] < errs[0]
    assert "wrote" in capsys.readouterr().out

"""Parity of the port's MCS Stokes family (navier_stokes_tpu_torch
``models.stokes_mcs``) and of its MINRES on a bare tensor with the JAX
package.

Both packages assemble the H(div) x H(curl,div) x L2 triple (RT and BDM,
orders 1 and 2) on the channel with cylinder at maxh 0.3 (420 triangles)
from the same inputs; the port on the CPU, where its wrappers take the
kernels' plain versions.  Random inputs come from numpy generators with
fixed seeds.  Tolerances:

* host tables (A_loc, dof table, f, u_bc, free mask): 1e-13;
* the direct solve (scipy on the host in both packages): 1e-10;
* MINRES (``solve_mcs_minres`` and ``solvers.minres`` on a bare vector):
  equal counts, error histories within 1e-8 (relative; the first 30
  entries, tests/test_torch_stokes.py ``_histories_match``), solutions
  within 1e-8.  The MCS MINRES runs 100 steps: its Jacobi preconditioner
  (1 on the zero velocity diagonal) converges very slowly in both
  packages -- 50,000 steps leave a relative error of 2.5e-3 at maxh 0.06
  (tools/jax_stokes_reference.py) -- and over 100 steps the two solutions
  are still comparable entry by entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mcs2d_solve import (
    _rel,
    one_torch_thread,  # noqa: F401  (the module's thread limits)
)
from test_torch_stokes import _histories_match

from navier_stokes_tpu.mesh.generators import (
    channel_with_cylinder_mesh as jax_channel,
)
from navier_stokes_tpu.models import discretizations as jdisc
from navier_stokes_tpu.models import stokes as jst
from navier_stokes_tpu.models import stokes_mcs as jsm
from navier_stokes_tpu.solvers.minres import minres as jax_minres
from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh
from navier_stokes_tpu_torch.models import discretizations as tdisc
from navier_stokes_tpu_torch.models import stokes as tst
from navier_stokes_tpu_torch.models import stokes_mcs as tsm
from navier_stokes_tpu_torch.solvers.minres import minres

MAXH = 0.3
NAMES = dict(velocity_dirichlet="wall|inlet|cyl", velocity_neumann="outlet")


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, n))
    return q @ q.T + n * np.eye(n), rng.standard_normal(n)


def test_minres_bare_tensor_matches_jax():
    """A bare tensor rhs is one block: the solution is a tensor, with the
    JAX ``minres``'s count, history and solution on the same SPD system
    (the call ``solve_mcs_minres`` makes)."""
    A, b = _spd(60, 1)
    d = np.diag(A).copy()
    rj = jax_minres(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                    pre=lambda x: x / jnp.asarray(d), tol=1e-10,
                    maxsteps=200)
    At, dt = torch.from_numpy(A), torch.from_numpy(d)
    rt = minres(lambda x: At @ x, torch.from_numpy(b), pre=lambda x: x / dt,
                tol=1e-10, maxsteps=200)
    assert isinstance(rt.x, torch.Tensor) and rt.x.shape == (60,)
    assert rt.converged and rt.iterations == int(rj.iterations)
    _histories_match(np.asarray(rj.errors)[:rt.iterations + 1],
                     rt.errors[:rt.iterations + 1])
    assert _rel(rj.x, rt.x.numpy()) <= 1e-8
    assert _rel(np.linalg.solve(A, b), rt.x.numpy()) <= 1e-8


def test_minres_tuples_and_initial_guess():
    """Tuples stay tuples; ``initialize=False`` starts from ``sol`` for a
    bare tensor too."""
    A, b = _spd(40, 2)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    r1 = minres(lambda x: (At @ x[0],), (bt,), tol=1e-12, maxsteps=100)
    assert isinstance(r1.x, tuple) and len(r1.x) == 1
    x0 = torch.linalg.solve(At, bt) * 0.999
    r2 = minres(lambda x: At @ x, bt, sol=x0, initialize=False, tol=1e-12,
                maxsteps=100)
    assert isinstance(r2.x, torch.Tensor)
    assert _rel(r1.x[0].numpy(), r2.x.numpy()) <= 1e-10


@pytest.fixture(scope="module")
def meshes():
    return jax_channel(MAXH), channel_with_cylinder_mesh(MAXH)


def _systems(meshes, order, rt=True, uin=True):
    jm, tm = meshes
    Vj, Sj, Qj = jsm.mcs_discretization(order, rt)[0](jm, **NAMES)
    Vt, St, Qt = tsm.mcs_discretization(order, rt)[0](tm, **NAMES)
    sj = jsm.assemble_mcs_stokes(
        jm, Vj, Sj, Qj, jst.default_volume_force,
        jst.default_inlet_profile() if uin else None)
    st_ = tsm.assemble_mcs_stokes(
        tm, Vt, St, Qt, tst.default_volume_force,
        tst.default_inlet_profile() if uin else None)
    return sj, st_


@pytest.fixture(scope="module")
def rt2(meshes):
    return _systems(meshes, 2)


@pytest.mark.parametrize("order,rt", [(1, True), (2, True), (2, False)])
def test_mcs_tables_match_jax(meshes, order, rt):
    sj, st_ = _systems(meshes, order, rt)
    assert (sj.ndofs, sj.offsets) == (st_.ndofs, st_.offsets)
    np.testing.assert_array_equal(sj.eldofs, st_.eldofs)
    np.testing.assert_array_equal(sj.free, st_.free)
    for a, b in ((sj.A_loc, st_.A_loc), (sj.f, st_.f), (sj.u_bc, st_.u_bc)):
        assert np.abs(a - b).max() <= 1e-13 * max(np.abs(a).max(), 1.0)


def test_mcs_direct_matches_jax(rt2):
    sj, st_ = rt2
    xj, _ = jsm.solve_mcs_direct(sj)
    xt, secs = tsm.solve_mcs_direct(st_)
    assert secs > 0
    assert _rel(xj, xt) <= 1e-10


def test_mcs_minres_matches_jax(rt2):
    sj, st_ = rt2
    xj, rj = jsm.solve_mcs_minres(sj, tol=1e-8, maxsteps=100)
    xt, rt = tsm.solve_mcs_minres(st_, tol=1e-8, maxsteps=100,
                                  device="cpu")
    assert rt.iterations == int(rj.iterations) == 100
    assert isinstance(xt, np.ndarray)
    _histories_match(np.asarray(rj.errors), rt.errors, head=101)
    assert _rel(xj, xt) <= 1e-8


def test_solve_hcurldiv_matches_jax(meshes):
    """The run.py:175-215 driver through the catalog's ``hcurldiv``."""
    jm, tm = meshes
    vj, pj, ej, _, nj = jsm.solve_hcurldiv(jm, jdisc.hcurldiv(2)[0])
    vt, pt, et, secs, nt = tsm.solve_hcurldiv(tm, tdisc.hcurldiv(2)[0])
    assert nj == nt and ej == et == [] and secs > 0
    assert _rel(vj, vt) <= 1e-10
    assert _rel(pj, pt) <= 1e-10

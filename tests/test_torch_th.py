"""Parity of the port's Taylor-Hood model (navier_stokes_tpu_torch
``models.NavierStokes``) with the JAX package, in 2D and 3D.

Both packages build ``NavierStokes`` from the same inputs: the 2D channel
``channel_with_cylinder_mesh(0.3)`` (nu 1e-3, dt 1e-3, order 2, the
demo's inflow, a volume force) and the 24-tet Poiseuille-between-plates
mesh of tests/test_navier_stokes_mcs3d.py (nu 1, dt 1e-3, order 2); the
port on the CPU, where its wrappers take the kernels' plain versions.
The 3D solve and step run on the same plates at twice the resolution
(192 tets): on the 24-tet mesh the velocity has 36 free dofs, fewer than
the 40 Lanczos steps of the Bramble-Pasciak scaling, whose smallest Ritz
value then reads 0, so the JAX package's k is infinite there and its BPCG
returns NaN (after its 100,000 steps); the port's raises on the zero.
Tolerances:

* operators (A, mstar, B, B_raw, BT, Mv, preA, preMstar, preMv, preM,
  convection, the right-hand side f and u_bc): 1e-11 (relative, 2-norm);
* ``SolveInitial`` (tol 1e-10) with the JAX package's Bramble-Pasciak k:
  equal BPCG counts (or one apart where the two error histories straddle
  the threshold, as tests/test_torch_mcs2d_solve.py), the solution within
  1e-8;
* one f64 step from the JAX solution with the JAX Chebyshev bounds: CG
  counts within 1, u within 1e-6 of the step's increment.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mcs2d_solve import (
    _rel,
    one_torch_thread,  # noqa: F401  (the module's thread limits)
)

from navier_stokes_tpu.linalg.lanczos import (
    lanczos_eigenvalues as jax_lanczos,
)
from navier_stokes_tpu.mesh.generators import (
    channel_with_cylinder_mesh as jax_channel,
)
from navier_stokes_tpu.mesh.generators import extrude_to_tets, rectangle_mesh
from navier_stokes_tpu.models.navier_stokes import (
    NavierStokes as JaxNavierStokes,
)
from navier_stokes_tpu.precond.chebyshev import (
    chebyshev_preconditioner as jax_chebyshev,
)
from navier_stokes_tpu.solvers.bpcg import bp_scale_factor as jax_bp_scale
from navier_stokes_tpu.solvers.cg import cg as jax_cg
from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh
from navier_stokes_tpu_torch.mesh.mesh import Mesh
from navier_stokes_tpu_torch.models import NavierStokes


def uin2d(p):
    out = np.zeros((len(p), 2))
    out[:, 0] = 1.5 * 4 * p[:, 1] * (0.41 - p[:, 1]) / 0.41**2
    return out


def force2d(p):
    return np.stack([np.sin(3 * p[:, 0]) * p[:, 1], np.cos(2 * p[:, 1])],
                    axis=1)


def uin3d(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = p[:, 1] * (1.0 - p[:, 1])
    return out


def _plates(h=0.5, layers=1):
    jmesh = extrude_to_tets(rectangle_mesh(h, 1.0, 1.0),
                            np.linspace(0, 0.5, layers + 1))
    jmesh.tag_boundary_by_predicate(
        "outlet", lambda p: np.abs(p[:, :, 0] - 1.0) < 1e-9)
    rest = np.setdiff1d(jmesh.boundary_facets, jmesh.boundary_tags["outlet"])
    jmesh.boundary_tags["diri"] = rest.astype(np.int32)
    pmesh = Mesh(jmesh.points.copy(), jmesh.elements.copy(),
                 {k: np.asarray(v).copy()
                  for k, v in jmesh.boundary_tags.items()})
    return jmesh, pmesh


@functools.lru_cache(maxsize=None)
def _build(kind):
    """(JAX model, port model, the JAX Chebyshev bounds) of ``kind``: "2d"
    (the channel), "3d" (the 24-tet plates) or "3d-192" (the 192-tet
    plates)."""
    if kind == "2d":
        kw = dict(nu=1e-3, inflow="inlet", outflow="outlet",
                  wall="wall|cyl", uin=uin2d, timestep=1e-3, order=2,
                  volumeforce=force2d)
        jmesh, pmesh = jax_channel(0.3), channel_with_cylinder_mesh(0.3)
    else:
        kw = dict(nu=1.0, inflow="diri", outflow="outlet", wall="",
                  uin=uin3d, timestep=1e-3, order=2)
        jmesh, pmesh = _plates() if kind == "3d" else _plates(0.25, 2)
        assert pmesh.ne == (24 if kind == "3d" else 192)
    mj = JaxNavierStokes(jmesh, **kw)
    mp = NavierStokes(pmesh, device="cpu", **kw)
    # the JAX model's Chebyshev bounds (its Lanczos from PRNGKey(0))
    lams = jax_lanczos(mj.Mv, mj.preMv, mj.u_bc.reshape(-1), 30)
    beta = 1.05 * float(jnp.max(lams))
    bounds = (0.02 * beta, beta)
    mj._mass_cheb = jax_chebyshev(mj.Mv, mj.preMv, mj.u_bc.reshape(-1),
                                  degree=16, bounds=bounds)
    return dict(mj=mj, mp=mp, bounds=bounds, dim=kind)


@pytest.fixture(scope="module", params=["2d", "3d"])
def pair(request):
    return _build(request.param)


@pytest.fixture(scope="module", params=["2d", "3d-192"])
def solve_pair(request):
    return _build(request.param)


@pytest.mark.parametrize("op", ["A", "mstar", "B", "B_raw", "Mv", "preA",
                                "preMstar", "preMv", "convection"])
def test_velocity_operators_match_jax(pair, op):
    mj, mp = pair["mj"], pair["mp"]
    u = np.asarray(mj.u_bc).reshape(-1) + 0.1 * np.random.default_rng(
        1).standard_normal(mp.d * mp.n)
    want = np.asarray(getattr(mj, op)(jnp.asarray(u)))
    assert _rel(want, getattr(mp, op)(torch.from_numpy(u)).numpy()) <= 1e-11


def test_pressure_operators_and_data_match_jax(pair):
    mj, mp = pair["mj"], pair["mp"]
    p = np.random.default_rng(2).standard_normal(mp.Q.ndof)
    for op in ("BT", "preM"):
        want = np.asarray(getattr(mj, op)(jnp.asarray(p)))
        assert _rel(want, getattr(mp, op)(torch.from_numpy(p)).numpy()
                    ) <= 1e-11
    assert _rel(mj.u_bc, mp.u_bc.numpy()) <= 1e-12
    if pair["dim"] == "2d":
        assert _rel(mj.f, mp.f.numpy()) <= 1e-12
    assert mp.velocity.shape == (mp.d, mp.n)


def test_solve_initial_and_step_match_jax(solve_pair):
    pair = solve_pair
    mj, mp = pair["mj"], pair["mp"]
    u_bc = mj.u_bc
    f_mod = jnp.where(mj.free_s[None], mj.f - mj._stokesA_raw(u_bc),
                      0.0).reshape(-1)
    k = float(jax_bp_scale(mj.A, mj.preA, f_mod)[0])
    rj = mj.SolveInitial(iterative=True, tol=1e-10)
    rp = mp.SolveInitial(iterative=True, tol=1e-10, scale_k=k)
    assert bool(rj.converged) and rp.converged
    nj, np_ = int(rj.iterations), rp.iterations
    if nj != np_:
        n = min(nj, np_)
        lo, hi = sorted((float(np.asarray(rj.errors)[n]),
                         float(rp.errors[n])))
        assert abs(nj - np_) == 1 and 1e-10 / 1.5 <= lo < 1e-10 <= hi <= (
            1.5e-10), (nj, np_, lo, hi)
    assert _rel(mj.u, mp.u.numpy()) <= 1e-8
    assert _rel(mj.p, mp.p.numpy()) <= 1e-8
    assert mp.stokes_bpcg_iterations == np_ and mp.stokes_bpcg_time > 0

    # one step from the JAX solution, the JAX way (make_step_fn's body,
    # jitted once, with its CG counts)
    mp.load_state(u=np.asarray(mj.u), p=np.asarray(mj.p),
                  cheb_bounds=pair["bounds"])
    d, n = mp.d, mp.n
    Minv = mj._mass_chebyshev()

    def jax_step(u):
        temp = mj.convection(u).reshape(d, n) + mj.f - mj._stokesA_raw(
            u.reshape(d, n))
        temp = jnp.where(mj.free_s[None], temp, 0.0).reshape(-1)
        r1 = jax_cg(mj.mstar, temp, pre=mj.preMstar, tol=1e-4,
                    maxsteps=2000)
        r2 = jax_cg(lambda p: mj.B(Minv(mj.BT(p))), mj.B_raw(r1.x),
                    pre=mj.preM, tol=1e-8, maxsteps=500)
        return (u + mj.timestep * (r1.x - Minv(mj.BT(r2.x))),
                r1.iterations, r2.iterations)

    u0 = mj.u
    u_j, it1, it2 = jax.jit(jax_step)(u0)
    u_p = mp.make_step_fn()(mp.u)
    assert abs(mp.last_iterations["mstar"] - int(it1)) <= 1
    assert abs(mp.last_iterations["project"] - int(it2)) <= 1
    incr = np.linalg.norm(np.asarray(u_j) - np.asarray(u0))
    assert incr > 0
    assert np.linalg.norm(u_p.numpy() - np.asarray(u_j)) <= 1e-6 * incr
    # DoTimeStep moves the state by that step
    mp.DoTimeStep()
    assert torch.equal(mp.u, u_p)


@pytest.mark.parametrize("argv", [["--mcs"], []])
def test_2d_demo_runs_on_the_cpu(tmp_path, capsys, argv):
    """scripts/navier_stokes_2d.py (Taylor-Hood by default, ``--mcs``) and
    scripts/navier_stokes_cavity.py on coarse meshes: the initial solve, one
    step, the state written."""
    from navier_stokes_tpu_torch.scripts import navier_stokes_2d, \
        navier_stokes_cavity

    out = tmp_path / "ns2d.npz"
    assert navier_stokes_2d.main(["1", "0.3", "--device", "cpu", "--out",
                                  str(out)] + argv) == 0
    assert "BPCG iterations" in capsys.readouterr().out
    assert np.isfinite(np.load(out)["velocity"]).all()
    cav = ["--taylor-hood"] if not argv else []
    assert navier_stokes_cavity.main(["1", "0.25", "--device", "cpu",
                                      "--out", str(out)] + cav) == 0
    state = np.load(out)
    assert np.isfinite(state["pressure"]).all()
    assert abs(float(state["pressure"].mean())) < 1e-8 * float(
        np.abs(state["pressure"]).max())

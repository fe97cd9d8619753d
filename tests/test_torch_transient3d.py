"""Parity of the port's transient SIMPLE step (navier_stokes_tpu_torch) with
the JAX package, piece by piece and as a whole.

Two model pairs, each built from the SAME host tables (the JAX model's
assembly cache through ``load_host_tables``), the port on the CPU where its
wrappers take the kernels' plain versions:

* ``channel``: ``channel_with_cylinder_mesh_3d(0.6)``, straight, f64 -- the
  pieces, compared eagerly (no jitted step: it compiles slowly);
* ``plates``: the 24-tet Poiseuille-between-plates mesh of
  tests/test_navier_stokes_mcs3d.py, f64 and f32 -- cg, Lanczos, Chebyshev,
  ``Project`` and whole steps.

Tolerances (relative, in the 2-norm unless said otherwise):

* f64 pieces ``convection``, ``mstar``, ``_Mv``, ``preMstar``, ``_preMv``,
  ``block(p)`` and the whole ``_pre_proj_twolevel`` apply: 1e-11 (sums in
  another order);
* ``elem_apply_ds`` / ``rect_apply_ds`` against the JAX layout's own methods:
  1e-6 -- each of the three f32 products is summed in another order on the
  two sides, so they agree to f32 accumulation error (5e-8 to 1.1e-7 here),
  not to f64 roundoff -- and against the f64 operator: 1e-6;
* ``cg`` on the same SPD system: equal iteration counts, x to 1e-10;
  ``lanczos_eigenvalues``: lambda_max within 2% of the JAX package's (the
  start vectors differ); ``chebyshev_preconditioner`` with the same bounds:
  1e-11;
* ``Project``: ||B u_new|| < 1e-5 ||B v||, CG count within 1 of JAX's;
* f64 steps (one and three) with the JAX package's Chebyshev bounds carried
  across: CG counts within 1, u within 1e-6 of the step's increment;
* one f32 step against the JAX f32 step: within 2e-3 of the increment.  The
  M* CG stops at a relative 1e-4 and the projection at 1e-5, both in f32, so
  the JAX f32 step itself differs from the JAX f64 step by that order (the
  test measures it and holds the port's f32 step to the same distance from
  the f64 step, within a factor 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.linalg.lanczos import (
    lanczos_eigenvalues as jax_lanczos,
)
from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.mesh.generators import extrude_to_tets, rectangle_mesh
from navier_stokes_tpu.models.navier_stokes_mcs import (
    NavierStokesMCS as JaxNavierStokesMCS,
)
from navier_stokes_tpu.precond.chebyshev import (
    chebyshev_preconditioner as jax_chebyshev,
)
from navier_stokes_tpu.solvers.cg import cg as jax_cg
from navier_stokes_tpu_torch.flagship import build_model, transient_steps, uin
from navier_stokes_tpu_torch.linalg.lanczos import lanczos_eigenvalues
from navier_stokes_tpu_torch.mesh.mesh import Mesh
from navier_stokes_tpu_torch.models import NavierStokesMCS, load_host_tables
from navier_stokes_tpu_torch.ops.block_mv import split_f64
from navier_stokes_tpu_torch.precond.chebyshev import chebyshev_preconditioner
from navier_stokes_tpu_torch.solvers.cg import cg

MAXH = 0.6


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


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _flat(cache):
    return {f"{key}_{i}": a for key, tup in cache.items()
            for i, a in enumerate(tup)}


def _jax_cheb_bounds(mj):
    """The (alpha, beta) that ``mj._mass_chebyshev()`` would compute, and
    the model's Chebyshev mass inverse built from them."""
    lams = jax_lanczos(mj._Mv, mj._preMv, mj.u_bc, 30)
    beta = 1.05 * float(jnp.max(lams))
    alpha = 0.02 * beta
    mj._mass_cheb = jax_chebyshev(mj._Mv, mj._preMv, mj.u_bc, degree=16,
                                  bounds=(alpha, beta))
    return alpha, beta


@pytest.fixture(scope="module")
def channel(one_torch_thread):
    cache = {}
    mj = JaxNavierStokesMCS(
        channel_with_cylinder_mesh_3d(MAXH), nu=1e-3, inflow="inlet",
        outflow="outlet", wall="wall|cyl", uin=uin, timestep=2e-3, order=2,
        preconditioner="faceblock", assembly_cache=cache)
    mp = build_model(MAXH, device="cpu", curved=False,
                     assembly_cache=load_host_tables(_flat(cache)))
    return dict(mj=mj, mp=mp)


def _plates_uin(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = p[:, 1] * (1.0 - p[:, 1])
    return out


@pytest.fixture(scope="module")
def plates(one_torch_thread):
    """tests/test_navier_stokes_mcs3d.py's plates setup, in both packages
    and both precisions, with the JAX f64 model's Chebyshev bounds carried
    into every other model."""
    base = rectangle_mesh(0.5, 1.0, 1.0)
    jmesh = extrude_to_tets(base, np.linspace(0, 0.5, 2))
    jmesh.tag_boundary_by_predicate(
        "outlet", lambda p: np.abs(p[:, :, 0] - 1.0) < 1e-9)
    rest = np.setdiff1d(jmesh.boundary_facets, jmesh.boundary_tags["outlet"])
    jmesh.boundary_tags["diri"] = rest.astype(np.int32)
    pmesh = Mesh(jmesh.points.copy(), jmesh.elements.copy(),
                 {k: np.asarray(v).copy()
                  for k, v in jmesh.boundary_tags.items()})
    kw = dict(nu=1.0, inflow="diri", outflow="outlet", wall="",
              uin=_plates_uin, timestep=1e-3, order=2)
    cache = {}
    mj = JaxNavierStokesMCS(jmesh, preconditioner="faceblock",
                            assembly_cache=cache, **kw)
    mj32 = JaxNavierStokesMCS(jmesh, preconditioner="faceblock",
                              assembly_cache=cache, dtype=jnp.float32, **kw)
    bounds = _jax_cheb_bounds(mj)
    mj32._mass_cheb = jax_chebyshev(mj32._Mv, mj32._preMv, mj32.u_bc,
                                    degree=16, bounds=bounds)
    carried = {**_flat(cache), "cheb_bounds": np.asarray(bounds)}
    mp = NavierStokesMCS(pmesh, device="cpu",
                         assembly_cache=load_host_tables(carried), **kw)
    mp32 = NavierStokesMCS(pmesh, device="cpu", dtype=torch.float32,
                           assembly_cache=load_host_tables(carried), **kw)
    return dict(mj=mj, mj32=mj32, mp=mp, mp32=mp32, bounds=bounds)


def _jax_step(mj, u, project_tol, mstar_tol=1e-4):
    """One SIMPLE step with the JAX package's pieces (make_step_fn's body),
    returning the CG counts beside the new state."""
    Minv = mj._mass_chebyshev()
    temp = jnp.where(mj.free, mj.convection(u) + mj.f - mj.A_raw(u), 0.0)
    r1 = jax_cg(mj.mstar, temp, pre=mj.preMstar, tol=mstar_tol, maxsteps=2000)

    def S(p):
        return mj.B(Minv(mj.BT(p)))

    r2 = jax_cg(S, mj.B_raw(r1.x), pre=mj._pre_proj_twolevel(),
                tol=project_tol, maxsteps=2000)
    temp2 = r1.x - Minv(mj.BT(r2.x))
    return u + mj.timestep * temp2, {"mstar": int(r1.iterations),
                                     "project": int(r2.iterations)}


# -- the pieces, f64, on the channel ---------------------------------------------


def test_carried_state_and_dtype(plates):
    mj, mp, mp32 = plates["mj"], plates["mp"], plates["mp32"]
    assert mp.dtype == torch.float64 and mp32.dtype == torch.float32
    assert mp32.u.dtype == mp32._A_cond.dtype == torch.float32
    assert mp._mass_chebyshev().bounds == pytest.approx(plates["bounds"],
                                                        rel=1e-15)
    rng = np.random.default_rng(0)
    u, p = rng.standard_normal(mp.n), rng.standard_normal(mp.Q.ndof)
    m2 = NavierStokesMCS(
        mp.mesh, nu=1.0, inflow="diri", outflow="outlet", wall="",
        uin=_plates_uin, timestep=1e-3, order=2, device="cpu",
        assembly_cache={"tabs3d": mp_tables(mp),
                        "cond": (mp._Acc_inv, mp.A_cond_np),
                        "state": {"u": u, "p": p}})
    np.testing.assert_array_equal(m2.u.numpy(), u)
    np.testing.assert_array_equal(m2.p.numpy(), p)
    np.testing.assert_array_equal(m2.velocity, u[: m2.V.ndof])
    np.testing.assert_array_equal(m2.pressure, -p)
    np.testing.assert_array_equal(mp.u.numpy(), np.asarray(mj.u))
    with pytest.raises(ValueError):
        m2.load_state(u=u[:-1])


def mp_tables(mp):
    """A model's own (A_ret, ..., B_loc) slot: only M_full and B_loc are
    read back after condensation."""
    return (None, None, None, mp._M_loc_np, mp.B_loc_np)


@pytest.mark.parametrize("op", ["convection", "mstar", "_Mv", "preMstar",
                                "_preMv"])
def test_f64_velocity_pieces_match_jax(channel, op):
    mj, mp = channel["mj"], channel["mp"]
    rng = np.random.default_rng(3)
    u = np.asarray(mj.u_bc) + 0.1 * np.where(
        np.asarray(mj.free), rng.standard_normal(mp.n), 0.0)
    want = np.asarray(getattr(mj, op)(jnp.asarray(u)))
    got = getattr(mp, op)(torch.from_numpy(u))
    assert got.dtype == torch.float64
    assert _rel(want, got.numpy()) <= 1e-11


@pytest.mark.parametrize("part", ["block", "pre"])
def test_projection_preconditioner_matches_jax(channel, part):
    mj, mp = channel["mj"], channel["mp"]
    prej, prep = mj._pre_proj_twolevel(), mp._pre_proj_twolevel()
    if part == "block":
        prej = next(c.cell_contents for c in prej.__closure__
                    if getattr(c.cell_contents, "__name__", "") == "block")
        prep = prep.block
    p = np.random.default_rng(4).standard_normal(mp.Q.ndof)
    want = np.asarray(prej(jnp.asarray(p)))
    assert _rel(want, prep(torch.from_numpy(p)).numpy()) <= 1e-11


def test_ds_applies_match_jax_layout(channel):
    """The plain 3 x f32 double-single A, B, BT applies against the JAX
    layout's own ``elem_apply_ds`` / ``rect_apply_ds`` (f32 accumulation
    order differs: 1e-6) and against the f64 operators (1e-6)."""
    mj, mp = channel["mj"], channel["mp"]
    f32 = torch.float32
    Ah, Al = split_f64(mp._A_cond)
    Bh, Bl = split_f64(mp._B_perm)
    A_ds = mp.fb.elem_apply_ds(Ah, Al)
    B_ds, BT_ds = mp.fb.rect_apply_ds(Bh, Bl, mp.Q.element_dofs)
    jA = mj.fb.elem_apply_ds(jnp.asarray(Ah.numpy()), jnp.asarray(Al.numpy()))
    jB, jBT = mj.fb.rect_apply_ds(
        jnp.asarray(Bh.numpy()), jnp.asarray(Bl.numpy()), mj.Q.element_dofs,
        mj.Q.ndof)
    rng = np.random.default_rng(5)
    u, p = rng.standard_normal(mp.n), rng.standard_normal(mp.Q.ndof)
    for got_fn, jax_fn, ref_fn, x in ((A_ds, jA, mp.A_raw, u),
                                      (B_ds, jB, mp.B_raw, u),
                                      (BT_ds, jBT, mp.fb.rect_apply(
                                          mp._B_perm, mp.Q.element_dofs)[1],
                                       p)):
        got = got_fn(torch.from_numpy(x))
        assert got.dtype == torch.float64
        assert _rel(np.asarray(jax_fn(jnp.asarray(x))), got.numpy()) <= 1e-6
        assert _rel(ref_fn(torch.from_numpy(x)).numpy(), got.numpy()) <= 1e-6
    assert A_ds.tables[0].dtype == f32


# -- solvers ----------------------------------------------------------------------


def test_cg_matches_jax(plates):
    """PCG on M* with its Jacobi preconditioner from the same right-hand
    side: equal counts, x to 1e-10, the error history to 1e-6 while it is
    above 1e-6 (below, roundoff in rho separates the two)."""
    mj, mp = plates["mj"], plates["mp"]
    b = np.where(np.asarray(mj.free),
                 np.random.default_rng(6).standard_normal(mp.n), 0.0)
    rj = jax_cg(mj.mstar, jnp.asarray(b), pre=mj.preMstar, tol=1e-10,
                maxsteps=400)
    rp = cg(mp.mstar, torch.from_numpy(b), pre=mp.preMstar, tol=1e-10,
            maxsteps=400)
    assert rp.converged and bool(rj.converged)
    assert rp.iterations == int(rj.iterations)
    assert _rel(np.asarray(rj.x), rp.x.numpy()) <= 1e-10
    it = rp.iterations
    ej = np.asarray(rj.errors)[: it + 1]
    head = ej > 1e-6
    assert head.sum() > 10
    np.testing.assert_allclose(rp.errors[: it + 1][head], ej[head], rtol=1e-6)
    assert np.isnan(rp.errors[it + 1:]).all()
    assert rp.err0 == pytest.approx(float(rj.err0), rel=1e-12)


def test_cg_stops_at_maxsteps_and_takes_x0(plates):
    mp = plates["mp"]
    b = torch.where(mp.free, torch.from_numpy(
        np.random.default_rng(7).standard_normal(mp.n)), 0.0)
    cut = cg(mp.mstar, b, pre=mp.preMstar, tol=1e-12, maxsteps=3)
    assert cut.iterations == 3 and not cut.converged
    full = cg(mp.mstar, b, pre=mp.preMstar, tol=1e-12, maxsteps=400)
    again = cg(mp.mstar, b, pre=mp.preMstar, x0=full.x, tol=1e-6,
               rel_err=False, maxsteps=400)
    assert again.iterations == 0 and again.converged
    assert torch.equal(again.x, full.x)


@pytest.mark.parametrize("which", ["plates", "channel"])
def test_lanczos_lambda_max_matches_jax(plates, channel, which):
    pair = plates if which == "plates" else channel
    mj, mp = pair["mj"], pair["mp"]
    lj = np.asarray(jax_lanczos(mj._Mv, mj._preMv, mj.u_bc, 30))
    lp = lanczos_eigenvalues(mp._Mv, mp._preMv, mp.u_bc, 30)
    assert lp.shape == (30,) and np.all(np.diff(lp) >= 0)
    assert abs(lp.max() - lj.max()) <= 0.02 * lj.max()
    # the same start vector on both sides does not exist (PRNGKey(0)); the
    # port's own draw is repeatable, and a given start vector is used
    again = lanczos_eigenvalues(mp._Mv, mp._preMv, mp.u_bc, 30)
    np.testing.assert_array_equal(lp, again)
    v0 = torch.from_numpy(np.random.default_rng(8).standard_normal(mp.n))
    lv = lanczos_eigenvalues(mp._Mv, mp._preMv, mp.u_bc, 30, v0=v0)
    assert abs(lv.max() - lj.max()) <= 0.02 * lj.max()


def test_chebyshev_matches_jax_with_same_bounds(plates):
    mj, mp = plates["mj"], plates["mp"]
    x = np.random.default_rng(9).standard_normal(mp.n)
    for degree, bounds in ((16, plates["bounds"]), (4, (0.3, 2.5))):
        cj = jax_chebyshev(mj._Mv, mj._preMv, mj.u_bc, degree=degree,
                           bounds=bounds)
        cp = chebyshev_preconditioner(mp._Mv, mp._preMv, mp.u_bc,
                                      degree=degree, bounds=bounds)
        assert cp.bounds == tuple(bounds)
        assert _rel(np.asarray(cj(jnp.asarray(x))),
                    cp(torch.from_numpy(x)).numpy()) <= 1e-11
    own = chebyshev_preconditioner(mp._Mv, mp._preMv, mp.u_bc, degree=16,
                                   lower_fraction=0.02)
    assert own.bounds[1] == pytest.approx(plates["bounds"][1], rel=0.02)
    assert own.bounds[0] == pytest.approx(0.02 * own.bounds[1])


# -- projection and whole steps ------------------------------------------------------


def test_project_is_divergence_free_with_jax_count(plates):
    mj, mp = plates["mj"], plates["mp"]
    mask = np.asarray(mj.free & mj._umask)
    v = np.where(mask, np.random.default_rng(0).standard_normal(mp.n), 0.0)
    Minv = mj._mass_chebyshev()
    rj = jax_cg(lambda p: mj.B(Minv(mj.BT(p))), mj.B_raw(jnp.asarray(v)),
                pre=mj._pre_proj_twolevel(), tol=1e-9, maxsteps=2000)
    vt = torch.from_numpy(v)
    u_new = mp.Project(vt)
    assert float(torch.linalg.norm(mp.B_raw(u_new))) < 1e-5 * float(
        torch.linalg.norm(mp.B_raw(vt)))
    assert abs(mp.last_iterations["project"] - int(rj.iterations)) <= 1
    assert _rel(np.asarray(rj.x), mp.p.numpy()) <= 1e-7
    want = np.asarray(mj.Project(jnp.asarray(v)))
    assert _rel(want, u_new.numpy()) <= 1e-8


@pytest.mark.parametrize("nsteps", [1, 3])
def test_f64_steps_match_jax(plates, nsteps):
    mj, mp = plates["mj"], plates["mp"]
    step_j = mj.make_step_fn()
    u_j = u_c = mj.u_bc
    counts_j = []
    for _ in range(nsteps):
        u_c, c = _jax_step(mj, u_c, 1e-9)
        counts_j.append(c)
        u_j = step_j(u_j)
    # the pieces above are the JAX step
    assert _rel(np.asarray(u_j), np.asarray(u_c)) <= 1e-13
    u_p, counts_p = transient_steps(mp, nsteps, project_tol=1e-9)
    assert len(counts_p) == nsteps
    for cp, cj in zip(counts_p, counts_j):
        assert abs(cp["mstar"] - cj["mstar"]) <= 1
        assert abs(cp["project"] - cj["project"]) <= 1
    incr = np.linalg.norm(np.asarray(u_j) - np.asarray(mj.u_bc))
    assert incr > 0 and bool(torch.isfinite(u_p).all())
    assert np.linalg.norm(u_p.numpy() - np.asarray(u_j)) <= 1e-6 * incr
    # the model's own state moves only through DoTimeStep
    np.testing.assert_array_equal(mp.u.numpy(), np.asarray(mj.u_bc))


def test_f32_step_matches_jax_f32_step(plates):
    mj, mj32, mp32 = plates["mj"], plates["mj32"], plates["mp32"]
    u64 = np.asarray(mj.make_step_fn(project_tol=1e-5)(mj.u_bc), np.float64)
    u_j = np.asarray(mj32.make_step_fn(project_tol=1e-5)(mj32.u_bc),
                     np.float64)
    u_p, counts = transient_steps(mp32, 1, project_tol=1e-5)
    assert u_p.dtype == torch.float32
    u_p = u_p.numpy().astype(np.float64)
    incr = np.linalg.norm(u64 - np.asarray(mj.u_bc))
    d_jax = np.linalg.norm(u_j - u64) / incr  # what f32 costs the JAX step
    d_port = np.linalg.norm(u_p - u64) / incr
    assert np.linalg.norm(u_p - u_j) / incr <= 2e-3
    assert d_port <= 2.0 * max(d_jax, 1e-4)
    _, cj = _jax_step(mj32, mj32.u_bc, 1e-5)
    assert abs(counts[0]["mstar"] - cj["mstar"]) <= 2
    assert abs(counts[0]["project"] - cj["project"]) <= 2


def test_do_time_step_and_solve_initial_timesteps(plates):
    """``DoTimeStep`` moves the model's state by the step function, and
    ``SolveInitial(timesteps=2)`` (pseudo-time Stokes steps, each projected)
    matches the JAX package's; ``SolveInitial()`` is the BPCG initial solve,
    which converges (tests/test_torch_bpcg.py holds it to the JAX
    package's)."""
    mj, mp = plates["mj"], plates["mp"]
    u0, p0, uj0, pj0 = mp.u, mp.p, mj.u, mj.p
    try:
        want, _ = transient_steps(mp, 1)
        mp.DoTimeStep()
        assert torch.equal(mp.u, want)
        mp.u = u0
        mp.SolveInitial(timesteps=2)
        mj.SolveInitial(timesteps=2)
        assert _rel(np.asarray(mj.u), mp.u.numpy()) <= 1e-8
        assert float(torch.linalg.norm(mp.B_raw(mp.u))) <= 1e-7
        res = mp.SolveInitial(tol=1e-10, maxsteps=5000)
        assert res.converged and mp.stokes_bpcg_iterations == res.iterations
        assert float(torch.linalg.norm(mp.B_raw(mp.u))) <= 1e-7
    finally:
        mp.u, mp.p, mj.u, mj.p = u0, p0, uj0, pj0


def test_left_out_parts_raise(plates):
    """The flagship solve refuses a float32 model."""
    from navier_stokes_tpu_torch.flagship import FlagshipSolve

    with pytest.raises(TypeError, match="float64"):
        FlagshipSolve(plates["mp32"])

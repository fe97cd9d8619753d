"""Parity of the port's 3D MCS Reynolds-number ensemble
(``make_viscosity_step_mcs`` through the face-block layout) and of the
repaired ``FaceBlockLayout.elem_apply_multi`` with the JAX package.

* The nu-split tables on the straight channel at maxh 0.6 (the JAX model's
  host tables carried into the port): G1, G2, G3 within 1e-12 of their
  largest entry; ``nu G1 + G2 + G3 / nu`` at nu = 0.004 against a fresh
  port model's condensation within 1e-10 of its largest entry (the JAX
  test's check).
* The step and the ensemble on the plates of
  tests/test_navier_stokes_mcs3d.py (24 tets, nu = 1e-3; one step on the
  channel takes a minute on one CPU thread): one step at nu = 2e-3 and the
  ensemble of 4 viscosities over 2 steps row by row, 1e-8 relative; the
  member at the model's nu against ``DoTimeStep``, 1e-6 of max |u| (the
  JAX test's bound).  The JAX model's Chebyshev bounds are carried into
  the port.
* ``elem_apply_multi``: float64 tables with a float and a 0-d tensor scale
  give the float64 einsum to 1e-14 relative; float32 tables give the sum
  of ``block_mv`` terms bitwise, as before the repair.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.linalg.lanczos import (
    lanczos_eigenvalues as jax_lanczos,
)
from navier_stokes_tpu.mesh.generators import (
    channel_with_cylinder_mesh_3d as jax_channel_3d,
)
from navier_stokes_tpu.mesh.generators import extrude_to_tets, rectangle_mesh
from navier_stokes_tpu.models.navier_stokes_mcs import (
    NavierStokesMCS as JaxNavierStokesMCS,
)
from navier_stokes_tpu.parallel import sweep as jax_sweep
from navier_stokes_tpu.precond.chebyshev import (
    chebyshev_preconditioner as jax_chebyshev,
)
from navier_stokes_tpu_torch.flagship import build_model, uin
from navier_stokes_tpu_torch.mesh import Mesh
from navier_stokes_tpu_torch.models import NavierStokesMCS
from navier_stokes_tpu_torch.models.navier_stokes_mcs import load_host_tables
from navier_stokes_tpu_torch.ops.block_mv import block_mv
from navier_stokes_tpu_torch.parallel import sweep

NUS = np.geomspace(1e-3, 1e-2, 4)


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


@functools.lru_cache(maxsize=None)
def _channel():
    cache = {}
    mj = JaxNavierStokesMCS(
        jax_channel_3d(0.6), nu=1e-3, inflow="inlet", outflow="outlet",
        wall="wall|cyl", uin=uin, timestep=2e-3, order=2,
        preconditioner="faceblock", assembly_cache=cache)
    mp = build_model(0.6, device="cpu", curved=False,
                     assembly_cache=load_host_tables(_flat(cache)))
    return mj, mp


def _plates_uin(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = p[:, 1] * (1.0 - p[:, 1])
    return out


@functools.lru_cache(maxsize=None)
def _plates():
    jmesh = extrude_to_tets(rectangle_mesh(0.5, 1.0, 1.0),
                            np.linspace(0, 0.5, 2))
    jmesh.tag_boundary_by_predicate(
        "outlet", lambda p: np.abs(p[:, :, 0] - 1.0) < 1e-9)
    rest = np.setdiff1d(jmesh.boundary_facets, jmesh.boundary_tags["outlet"])
    jmesh.boundary_tags["diri"] = rest.astype(np.int32)
    pmesh = Mesh(jmesh.points.copy(), jmesh.elements.copy(),
                 {k: np.asarray(v).copy()
                  for k, v in jmesh.boundary_tags.items()})
    kw = dict(nu=1e-3, inflow="diri", outflow="outlet", wall="",
              uin=_plates_uin, timestep=1e-3, order=2)
    mj = JaxNavierStokesMCS(jmesh, preconditioner="faceblock", **kw)
    mp = NavierStokesMCS(pmesh, device="cpu", **kw)
    beta = 1.05 * float(jnp.max(jax_lanczos(mj._Mv, mj._preMv, mj.u_bc, 30)))
    bounds = (0.02 * beta, beta)
    mj._mass_cheb = jax_chebyshev(mj._Mv, mj._preMv, mj.u_bc, degree=16,
                                  bounds=bounds)
    mp.load_state(cheb_bounds=bounds)
    return mj, mp


def test_split_tables_match_jax_and_a_fresh_condensation():
    mj, mp = _channel()
    tables = sweep.mcs_nu_split_tables(mp)
    for want, got in zip(jax_sweep.mcs_nu_split_tables(mj), tables):
        assert got.shape == want.shape and got.dtype == np.float64
        scale = max(np.abs(want).max(), 1e-300)
        assert np.abs(got - want).max() <= 1e-12 * scale
    G1, G2, G3 = tables
    nu2 = 0.004
    fresh = build_model(0.6, nu=nu2, device="cpu", curved=False,
                        mesh=mp.mesh)
    ref = np.asarray(fresh.A_cond_np)
    pred = nu2 * G1 + G2 + G3 / nu2
    assert np.abs(pred - ref).max() / np.abs(ref).max() < 1e-10


def test_step_matches_jax():
    mj, mp = _plates()
    u0 = np.array(mj.u_bc)
    want = np.asarray(jax_sweep.make_viscosity_step_mcs(mj)(
        jnp.asarray(u0), jnp.asarray(2e-3)))
    step = sweep.make_viscosity_step_mcs(mp)
    got = step(torch.from_numpy(u0), torch.tensor(2e-3, dtype=torch.float64))
    assert _rel(want, got.numpy()) <= 1e-8
    # the tables the step streams: face-major f64 device tables
    assert set(step.tables) == {"G1", "G2", "G3", "M"}
    for name, t in step.tables.items():
        assert t.dtype == torch.float64 and t.is_contiguous(), name
        assert t.shape == (mp.fb.ne, mp.fb.nb, mp.fb.nb), name


def test_ensemble_matches_jax_row_by_row():
    mj, mp = _plates()
    want = np.asarray(jax_sweep.run_reynolds_ensemble_mcs(mj, NUS, 2))
    log = []
    got = sweep.run_reynolds_ensemble_mcs(mp, NUS, 2, log=log)
    assert got.shape == (len(NUS), mp.n) and got.dtype == torch.float64
    assert bool(torch.isfinite(got).all())
    for i in range(len(NUS)):
        assert _rel(want[i], got[i].numpy()) <= 1e-8, i
    assert float((got[0] - got[-1]).abs().max()) > 1e-8
    assert len(log) == 2 * len(NUS)
    # members run alone give their rows bitwise
    alone = sweep.run_reynolds_ensemble_mcs(mp, NUS[-1:], 2)
    assert torch.equal(alone[0], got[-1])


def test_member_at_model_nu_matches_do_time_step():
    _, mp = _plates()
    u0 = mp.u
    row = sweep.run_reynolds_ensemble_mcs(mp, [mp.nu], 1)[0]
    mp.DoTimeStep()
    try:
        scale = float(mp.u.abs().max())
        assert float((row - mp.u).abs().max()) / scale < 1e-6
    finally:
        mp.u = u0


def test_elem_apply_multi_f64_tables_in_f64():
    _, mp = _plates()
    lay = mp.fb
    rng = np.random.default_rng(3)
    tabs = [rng.standard_normal((lay.ne, lay.nb, lay.nb)) for _ in range(3)]
    u = torch.from_numpy(rng.standard_normal(mp.n))
    c = torch.tensor(0.37, dtype=torch.float64)
    got = lay.elem_apply_multi([(tabs[0], 2.5), (torch.from_numpy(tabs[1]),
                                                 None), (tabs[2], c)])(u)
    uF, ui = lay.split(u)
    ue = lay.gather_elem(uF, ui)
    ye = sum(s * torch.einsum("eij,ej->ei", torch.from_numpy(A), ue)
             for A, s in zip(tabs, (2.5, 1.0, c)))
    want = lay.join(*lay.scatter_elem(ye))
    assert got.dtype == torch.float64
    assert _rel(want.numpy(), got.numpy()) <= 1e-14
    with pytest.raises(ValueError):
        lay.elem_apply_multi([(tabs[0], None), (tabs[1].astype(np.float32),
                                                None)])


def test_elem_apply_multi_f32_tables_unchanged():
    """float32 tables: each term a ``block_mv`` of the table, summed -- the
    route before the float64 repair, bitwise."""
    _, mp = _plates()
    lay = mp.fb
    rng = np.random.default_rng(4)
    tabs = [rng.standard_normal((lay.ne, lay.nb, lay.nb)).astype(np.float32)
            for _ in range(2)]
    u = torch.from_numpy(rng.standard_normal(mp.n).astype(np.float32))
    got = lay.elem_apply_multi([(tabs[0], None), (tabs[1], 0.5)])(u)
    uF, ui = lay.split(u)
    ue = lay.gather_elem(uF, ui).contiguous()
    ye = (block_mv(torch.from_numpy(tabs[0]), ue)
          + 0.5 * block_mv(torch.from_numpy(tabs[1]), ue))
    assert got.dtype == torch.float32
    assert torch.equal(got, lay.join(*lay.scatter_elem(ye)))


def test_ensemble_with_a_tighter_mstar_tol_matches_jax(monkeypatch):
    """``mstar_tol`` replaces the step's M* CG tolerance (the JAX step's
    1e-4): at 1e-10, against the JAX step with its M* CG to 1e-10, row by
    row, 1e-8 relative, with more M* iterations than at 1e-4."""
    mj, mp = _plates()
    real_cg = jax_sweep.cg
    monkeypatch.setattr(jax_sweep, "cg",
                        lambda *a, **k: real_cg(*a, **{**k, "tol": 1e-10}))
    want = np.asarray(jax_sweep.run_reynolds_ensemble_mcs(mj, NUS, 2))
    loose, tight = [], []
    sweep.run_reynolds_ensemble_mcs(mp, NUS[:1], 1, log=loose)
    got = sweep.run_reynolds_ensemble_mcs(mp, NUS, 2, log=tight,
                                          mstar_tol=1e-10)
    for i in range(len(NUS)):
        assert _rel(want[i], got[i].numpy()) <= 1e-8, i
    assert tight[0]["mstar"] > loose[0]["mstar"]


def test_carried_cell_bases_span_the_ports_null_space():
    """tools/jax_bdm2_cell_bases.npz (the JAX host's element-interior BDM_2
    functions, which chip_smoke.py carries into its JAX comparison model)
    holds, for all 24 face-orientation combos, an orthonormal basis of the
    port's own null space of the face moments; inside
    ``carried_cell_bases`` the port's bases take them, and outside its own
    come back."""
    import os

    import chip_smoke
    from navier_stokes_tpu_torch.fem import hdiv3d

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "jax_bdm2_cell_bases.npz")
    data = np.load(path)
    assert data["cells"].shape == (24, 6, 30)
    own = hdiv3d.bdm_tet
    for combo, cells in zip(data["combos"], data["cells"]):
        combo = tuple(tuple(int(p) for p in f) for f in combo)
        mine = own(2, combo).coeffs[24:]
        assert np.abs(cells @ cells.T - np.eye(6)).max() < 1e-12
        assert np.abs(cells - (cells @ mine.T) @ mine).max() < 1e-12
    with chip_smoke.carried_cell_bases(path) as cb:
        b = hdiv3d.bdm_tet(2, tuple(tuple(int(p) for p in f)
                                    for f in data["combos"][5]))
    assert hdiv3d.bdm_tet is own
    assert cb.combos == 1 and cb.off_span < 1e-12
    assert np.array_equal(b.coeffs[24:], data["cells"][5])
    assert np.array_equal(b.coeffs[:24], own(2, b.combo).coeffs[:24])

"""Parity of the port's checkpoints (``utils/checkpoint.py``), its C++ setup
kernels (``native/meshkit.cpp`` through ``utils/native.py``),
``linalg.lanczos.condition_estimate``, ``linalg.pytree.tnorm`` / ``tmask``
and ``mesh.generators.unit_cube_mesh`` with the JAX package.

* Checkpoints: a file written by either package loads into the other's
  Taylor-Hood model (``channel_with_cylinder_mesh(0.3)``, order 2) with the
  same keys and bitwise the same state; resuming repeats a step bitwise;
  a model of another mesh raises ValueError.
* meshkit: the library is built under the repository's ``build/``; the
  C++ routes against their own fallbacks (blocks bitwise, RCM a
  permutation of the same bandwidth class, ``build_edges`` raising) and
  against the JAX package's ``utils.native`` (the same edges in the same
  order, the same RCM permutation, the same blocks).
* ``condition_estimate``: within 2% of the JAX one with the port's own
  start vector, 1e-10 with the JAX start vector.  ``unit_cube_mesh``: equal
  arrays and boundary tags.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.fem.reference import TRI_EDGES
from navier_stokes_tpu.linalg.lanczos import (
    condition_estimate as jax_condition_estimate,
)
from navier_stokes_tpu.linalg.pytree import tmask as jax_tmask
from navier_stokes_tpu.linalg.pytree import tnorm as jax_tnorm
from navier_stokes_tpu.mesh.generators import (
    channel_with_cylinder_mesh as jax_channel,
)
from navier_stokes_tpu.mesh.generators import (
    unit_cube_mesh as jax_unit_cube_mesh,
)
from navier_stokes_tpu.mesh.generators import (
    unit_square_mesh as jax_unit_square_mesh,
)
from navier_stokes_tpu.models.navier_stokes import (
    NavierStokes as JaxNavierStokes,
)
from navier_stokes_tpu.utils import checkpoint as jax_checkpoint
from navier_stokes_tpu.utils import native as jax_native
from navier_stokes_tpu_torch.linalg import condition_estimate, tmask, tnorm
from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh
from navier_stokes_tpu_torch.mesh.generators import unit_cube_mesh
from navier_stokes_tpu_torch.models import NavierStokes
from navier_stokes_tpu_torch.precond import jacobi
from navier_stokes_tpu_torch.utils import checkpoint, native

KW = dict(nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
          timestep=1e-3, order=2, preconditioner="jacobi")


def uin(p):
    out = np.zeros((len(p), 2))
    out[:, 0] = 1.5 * 4 * p[:, 1] * (0.41 - p[:, 1]) / 0.41**2
    return out


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
def pair():
    mj = JaxNavierStokes(jax_channel(0.3), uin=uin, **KW)
    mp = NavierStokes(channel_with_cylinder_mesh(0.3), uin=uin,
                      device="cpu", **KW)
    rng = np.random.default_rng(5)
    mj.u = mj.u + 0.01 * jnp.asarray(rng.standard_normal(mj.u.shape))
    mj.p = jnp.asarray(rng.standard_normal(mj.Q.ndof))
    return mj, mp


# -- checkpoints -----------------------------------------------------------------


def test_jax_checkpoint_loads_into_the_port(tmp_path, pair):
    mj, mp = pair
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_state(path, mj, time=0.123, step=7)
    assert checkpoint.load_state(path, mp) == (0.123, 7)
    assert mp.u.dtype == mp.dtype and mp.u.device == mp.device
    np.testing.assert_array_equal(mp.u.numpy(), np.asarray(mj.u).reshape(-1))
    np.testing.assert_array_equal(mp.p.numpy(), np.asarray(mj.p))


def test_port_checkpoint_loads_into_jax(tmp_path, pair):
    mj, mp = pair
    rng = np.random.default_rng(6)
    mp.u = mp.u_bc.reshape(-1) + torch.from_numpy(
        rng.standard_normal(mp.d * mp.n))
    mp.p = torch.from_numpy(rng.standard_normal(mp.Q.ndof))
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    checkpoint.save_state(ours, mp, time=1.5, step=3)
    jax_checkpoint.save_state(theirs, mj)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in ("nu", "timestep", "order", "ndof_v", "ndof_q"):
            assert a[key] == b[key], key
    u_j, p_j = mj.u, mj.p
    try:
        assert jax_checkpoint.load_state(ours, mj) == (1.5, 3)
        np.testing.assert_array_equal(np.asarray(mj.u).reshape(-1),
                                      mp.u.numpy())
        np.testing.assert_array_equal(np.asarray(mj.p), mp.p.numpy())
    finally:
        mj.u, mj.p = u_j, p_j


def test_resume_repeats_a_step_bitwise(tmp_path, pair):
    _, mp = pair
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, mp, time=0.25, step=2)
    u0 = mp.u
    mp.u = torch.zeros_like(mp.u)
    assert checkpoint.load_state(path, mp) == (0.25, 2)
    assert torch.equal(mp.u, u0)
    mp.DoTimeStep()
    after = mp.u.clone()
    checkpoint.load_state(path, mp)
    mp.DoTimeStep()
    assert torch.equal(mp.u, after)


def test_checkpoint_of_another_mesh_raises(tmp_path, pair):
    _, mp = pair
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, mp)
    other = NavierStokes(channel_with_cylinder_mesh(0.4), uin=uin,
                         device="cpu", **KW)
    with pytest.raises(ValueError):
        checkpoint.load_state(path, other)


# -- meshkit ---------------------------------------------------------------------


def _csr_graph(mesh, shuffle):
    e0, e1 = shuffle[mesh.edges[:, 0]], shuffle[mesh.edges[:, 1]]
    rows = np.concatenate([e0, e1])
    cols = np.concatenate([e1, e0])
    return sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                         shape=(mesh.nv, mesh.nv)).tocsr()


def _blocks_case():
    rng = np.random.default_rng(0)
    n = 60
    dense = rng.standard_normal((n, n))
    dense[np.abs(dense) < 1.2] = 0.0
    blocks = -np.ones((5, 7), dtype=np.int32)
    for i in range(5):
        sz = rng.integers(2, 8)
        blocks[i, :sz] = rng.choice(n, size=sz, replace=False)
    return dense, sp.csr_matrix(dense), blocks


def test_meshkit_builds_under_build_dir():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "build"
    src_dir = path.parents[1] / "navier_stokes_tpu_torch" / "native"
    assert (src_dir / "meshkit.cpp").exists()
    assert not list(src_dir.glob("*.so"))


def test_meshkit_matches_jax_package():
    mesh = jax_unit_square_mesh(0.1)
    want = jax_native.build_edges(mesh.elements, TRI_EDGES)
    got = native.build_edges(mesh.elements, TRI_EDGES)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert {tuple(e) for e in got[0].tolist()} == {
        tuple(e) for e in mesh.edges.tolist()}
    shuffle = np.random.default_rng(0).permutation(mesh.nv).astype(np.int32)
    A = _csr_graph(mesh, shuffle)
    np.testing.assert_array_equal(native.rcm_ordering(A),
                                  jax_native.rcm_ordering(A))
    _, A, blocks = _blocks_case()
    np.testing.assert_array_equal(native.extract_blocks_csr(A, blocks),
                                  jax_native.extract_blocks_csr(A, blocks))


def test_meshkit_against_its_fallbacks(monkeypatch):
    dense, A, blocks = _blocks_case()
    fast = native.extract_blocks_csr(A, blocks)
    np.testing.assert_array_equal(fast, jacobi.extract_blocks_csr(A, blocks))
    for i in range(len(blocks)):
        b = blocks[i][blocks[i] >= 0]
        np.testing.assert_array_equal(fast[i, :len(b), :len(b)],
                                      dense[np.ix_(b, b)])
    mesh = jax_unit_square_mesh(0.1)
    shuffle = np.random.default_rng(1).permutation(mesh.nv).astype(np.int32)
    G = _csr_graph(mesh, shuffle)
    perm_fast = native.rcm_ordering(G)

    # without the library: a warning, then the scipy / numpy routes
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)

    def broken(out):
        raise OSError("no compiler")

    monkeypatch.setattr(native, "_compile", broken)
    monkeypatch.setattr(native, "library_path",
                        lambda: native._BUILD_DIR / "missing" / "lib.so")
    with pytest.warns(UserWarning, match="fallback"):
        assert not native.available()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.testing.assert_array_equal(native.extract_blocks_csr(A, blocks),
                                      fast)
        perm_slow = native.rcm_ordering(G)
    with pytest.raises(RuntimeError):
        native.build_edges(mesh.elements, TRI_EDGES)

    def bandwidth(perm):
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm), dtype=perm.dtype)
        e0, e1 = shuffle[mesh.edges[:, 0]], shuffle[mesh.edges[:, 1]]
        return int(np.abs(inv[e0].astype(int) - inv[e1].astype(int)).max())

    for perm in (perm_fast, perm_slow):
        assert sorted(perm.tolist()) == list(range(mesh.nv))
    bw_fast, bw_slow = bandwidth(perm_fast), bandwidth(perm_slow)
    assert bw_fast <= 3 * (round(mesh.nv**0.5) + 2)
    assert bw_fast <= 2 * bw_slow and bw_slow <= 2 * bw_fast


# -- condition_estimate, tnorm / tmask, unit_cube_mesh --------------------------


def test_condition_estimate_matches_jax():
    """On an SPD operator whose extreme eigenvalues (0.05 and 40) stand
    apart from the rest (1..2), which 40 Lanczos steps resolve from any
    start; Jacobi-preconditioned."""
    rng = np.random.default_rng(7)
    n = 200
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([[0.05], np.linspace(1.0, 2.0, n - 2), [40.0]])
    A = (Q * lam) @ Q.T
    d = np.diag(A).copy()
    want = jax_condition_estimate(lambda v: jnp.asarray(A) @ v,
                                  lambda v: v / jnp.asarray(d),
                                  jnp.zeros(n), 40)
    At, dt = torch.from_numpy(A), torch.from_numpy(d)
    got = condition_estimate(lambda v: At @ v, lambda v: v / dt,
                             torch.zeros(n, dtype=torch.float64), 40)
    assert all(isinstance(g, float) for g in got)
    for w, g in zip(want, got):
        assert abs(g - float(w)) <= 0.02 * abs(float(w))
    v0 = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float64)))
    same = condition_estimate(lambda v: At @ v, lambda v: v / dt,
                              torch.zeros(n, dtype=torch.float64), 40, v0=v0)
    for w, g in zip(want, same):
        assert abs(g - float(w)) <= 1e-10 * abs(float(w))


def test_tnorm_and_tmask_match_jax():
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(7), (rng.standard_normal(3),
                                  rng.standard_normal(4)))
    mask = (rng.random(7) > 0.5, (rng.random(3) > 0.5, rng.random(4) > 0.5))
    tx = (torch.from_numpy(x[0]), tuple(torch.from_numpy(a) for a in x[1]))
    tm = (torch.from_numpy(mask[0]),
          tuple(torch.from_numpy(a) for a in mask[1]))
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    assert abs(float(tnorm(tx)) - float(jax_tnorm(jx))) <= 1e-14 * float(
        jax_tnorm(jx))
    got = tmask(tm, tx)
    want = jax_tmask(jax.tree_util.tree_map(jnp.asarray, mask), jx)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(tnorm(torch.from_numpy(x[0]))) == pytest.approx(
        np.linalg.norm(x[0]), rel=1e-14)


@pytest.mark.parametrize("maxh", [0.5, 0.25])
def test_unit_cube_mesh_matches_jax(maxh):
    want, got = jax_unit_cube_mesh(maxh), unit_cube_mesh(maxh)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.elements, want.elements)
    assert set(got.boundary_tags) == set(want.boundary_tags)
    for name, facets in want.boundary_tags.items():
        np.testing.assert_array_equal(got.boundary_tags[name], facets)

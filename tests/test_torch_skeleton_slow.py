"""Parity of the port's dof-level skeleton preconditioner
(``build_skeleton_preconditioner_3d(..., fast=False)``) with the JAX
package's on ``channel_with_cylinder_mesh_3d(0.6)``, order 2, nu = 1e-3
(straight geometry), both built from the JAX model's condensed host table.

The GS cases are in tests/test_torch_skeleton_slow_gs.py and the
equilibrated one in tests/test_torch_skeleton_slow_scaled.py, which take
this file's fixtures: one JAX build per file keeps each under a minute.
Both run with every table in f64, the reference's unsymmetrized tables
(``symmetrize=False``) and the JAX slow path's coarse damping target 0.9.
Tolerances:

* the port's fast=False against the JAX package's fast=False, additive and
  GS, with and without the equilibration ``dof_scale``: 1e-7 relative on a
  seeded vector -- the JAX package's own bound between its two
  formulations (tests/test_skeleton_fast.py:66); measured 2.1e-16
  (additive), 2.9e-15 (GS) and 6.3e-16 (equilibrated): the same
  construction, sums in other orders;
* the port's fast path against its fast=False path: additive within 1e-7
  (measured 9.1e-10: each block inverted in another dof order); GS (the
  fast path buckets the blocks by size before coloring, so the two sweeps
  are different operators) a relative gap under 0.5 (measured 0.026) and
  symmetry to 1e-8 of the product's size -- the JAX package's checks
  (tests/test_skeleton_fast.py:50-66).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.models.auxspace3d import (
    build_skeleton_preconditioner_3d as jax_build,
)
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
from navier_stokes_tpu_torch.flagship import build_model, uin
from navier_stokes_tpu_torch.models import load_host_tables
from navier_stokes_tpu_torch.models.auxspace3d import (
    build_skeleton_preconditioner_3d,
)

MAXH = 0.6
F64 = torch.float64
ALL_F64 = dict(ext_dtype=F64, inv_dtype=F64, panel_dtype=F64,
               sweep_dtype=F64, coarse_target=0.9, symmetrize=False)


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
def pair(one_torch_thread):
    cache = {}
    mj = NavierStokesMCS(
        channel_with_cylinder_mesh_3d(MAXH), nu=1e-3, inflow="inlet",
        outflow="outlet", wall="wall|cyl", uin=uin, timestep=2e-3, order=2,
        preconditioner="faceblock", assembly_cache=cache)
    mp = build_model(MAXH, device="cpu", curved=False,
                     assembly_cache=load_host_tables(
                         {f"{key}_{i}": a for key, tup in cache.items()
                          for i, a in enumerate(tup)}))
    x = np.random.default_rng(5).standard_normal(mp.n)
    return dict(mj=mj, mp=mp, x=x, built={})


def _scaled(m):
    """(A~, D): the Jacobi equilibration of equilibrated_f32_ops."""
    eldofs = np.asarray(m.Xv.element_dofs)
    d = np.zeros(m.n)
    np.add.at(d, eldofs.ravel(), np.einsum("eii->ei", m.A_cond_np).ravel())
    free = np.asarray(m.Xv.free_mask)
    D = np.ones(m.n)
    D[free] = 1.0 / np.sqrt(np.abs(d[free]))
    De = D[eldofs]
    return m.A_cond_np * De[:, :, None] * De[:, None, :], D


def _port(pair, gs, fast, scaled=False):
    key = ("port", gs, fast, scaled)
    if key not in pair["built"]:
        mp = pair["mp"]
        A, D = _scaled(mp) if scaled else (mp.A_cond_np, None)
        pair["built"][key] = build_skeleton_preconditioner_3d(
            mp.Xv, A, mp._dirich, "cpu", F64, coarse_coefficient=mp.nu,
            dof_scale=D, gs=gs, fast=fast, **ALL_F64)
    return pair["built"][key]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_slow(pair, gs, scaled=False):
    """The JAX package's fast=False preA applied to the seeded vector."""
    mj = pair["mj"]
    A, D = _scaled(mj) if scaled else (mj.A_cond_np, None)
    pre_j = jax_build(mj.Xv, A, mj._dirich, jnp.float64,
                      coarse_coefficient=mj.nu, gs=gs, dof_scale=D,
                      fast=False)
    return np.asarray(pre_j(jnp.asarray(pair["x"])))


def check_against_jax(pair, gs, scaled=False):
    mp, x = pair["mp"], pair["x"]
    want = jax_slow(pair, gs, scaled)
    got = _port(pair, gs, False, scaled)(torch.as_tensor(x)).numpy()
    rel = _rel(got, want)
    assert rel < 1e-7, f"port fast=False vs JAX fast=False: {rel:.3e}"
    # unchanged on the constrained dofs, as JAX's
    fixed = ~np.asarray(mp.Xv.free_mask)
    np.testing.assert_array_equal(got[fixed], x[fixed])


def test_slow_path_matches_jax_slow_path(pair):
    check_against_jax(pair, gs=False)


def test_fast_matches_slow_additive(pair):
    x = torch.as_tensor(pair["x"])
    rel = _rel(_port(pair, False, True)(x), _port(pair, False, False)(x))
    assert rel < 1e-7, f"additive fast vs slow: {rel:.3e}"


def test_slow_path_additive_tables(pair):
    parts = _port(pair, False, False).parts
    tabs = parts["tables"]
    ne = pair["mp"].mesh.ne
    assert set(tabs) == {"ext", "inner", "block-Jacobi inverses"}
    assert tabs["ext"].shape[0] == ne and tabs["inner"].shape[0] == ne
    assert all(t.dtype == F64 for t in tabs.values())
    assert "smooth_only" in parts and "coarse_only" in parts
    mp = pair["mp"]
    with pytest.raises(ValueError):
        build_skeleton_preconditioner_3d(
            mp.Xv, mp.A_cond_np, mp._dirich, "cpu", torch.float32,
            fast=False, split_k=2)

"""Parity of the port's flagship slice (navier_stokes_tpu_torch) with the JAX
package on ``channel_with_cylinder_mesh_3d(0.6)``, order 2, nu = 1e-3.

Both packages build the bench configuration on straight geometry with the
additive skeleton preconditioner (``build_model(curved=False)``,
``FlagshipSolve(gs=False)``); the port also builds from the JAX model's own
host tables through ``load_host_tables``.  The JAX side runs on the CPU,
where its operator factories take their XLA einsum paths and
``equilibrated_f32_ops`` derives its tables on the host -- the math the
port runs on the card.  Tolerances:

* host tables: the element tables (A_ret, A_rc, A_cc, M_full, B_loc), the
  condensation (Acc_inv, A_cond), element dofs, free mask and u_bc are
  EQUAL (the port's copy does the same numpy operations in the same order);
  the pressure-mass diagonal behind preM to 1e-14 relative (the port sums
  the element contributions in another order);
* face-block layout conversions: equal; the f32 P1 face transfer: 1e-6;
* f64 A, B, BT applies: 1e-13 relative in norm (sums reordered);
* split-f32 A32, B32, BT32, preA32, preM32: 1e-5 relative in norm (f32
  arithmetic, preA with bf16-stored extension tables on both sides);
* compensated A_ds, B_ds, BT_ds against the JAX f64 operators: 1e-12;
* the first 30 entries of a MINRES error history on the equilibrated f32
  system: 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.models.auxspace3d import (
    hybrid_h1_face_transfer as jax_face_transfer,
)
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
from navier_stokes_tpu.solvers.minres import minres as jax_minres
from navier_stokes_tpu.solvers.refinement import (
    equilibrated_f32_ops as jax_equilibrated_f32_ops,
)
from navier_stokes_tpu_torch.flagship import FlagshipSolve, build_model, uin
from navier_stokes_tpu_torch.models import load_host_tables
from navier_stokes_tpu_torch.models.auxspace3d import hybrid_h1_face_transfer
from navier_stokes_tpu_torch.solvers.minres import minres

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


@pytest.fixture(scope="module")
def pair(one_torch_thread):
    cache = {}
    mj = NavierStokesMCS(
        channel_with_cylinder_mesh_3d(MAXH), nu=1e-3, inflow="inlet",
        outflow="outlet", wall="wall|cyl", uin=uin, timestep=2e-3, order=2,
        preconditioner="faceblock", assembly_cache=cache)
    own_cache = {}
    own = build_model(MAXH, device="cpu", assembly_cache=own_cache,
                      curved=False)
    mp = build_model(MAXH, device="cpu", assembly_cache=load_host_tables(
        {f"{key}_{i}": a for key, tup in cache.items()
         for i, a in enumerate(tup)}), curved=False)
    with pytest.MonkeyPatch.context() as mpatch:
        # bench.py's defaults on the additive path (bench.py:81-87)
        mpatch.setenv("NSTPU_SMOOTHER_BF16", "ext,inv")
        mpatch.setenv("NSTPU_DEVICE_TABLES", "0")
        ops32j, Dj, odsj = jax_equilibrated_f32_ops(
            mj, gs=False, split=True, with_ds=True)
    solver = FlagshipSolve(mp, gs=False)
    return dict(mj=mj, own=own, own_cache=own_cache, mp=mp, cache=cache,
                ops32j=ops32j, Dj=Dj,
                odsj=odsj, solver=solver)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.mark.parametrize("name", [
    "A_ret", "A_rc", "A_cc", "M_full", "B_loc", "Acc_inv", "A_cond"])
def test_own_host_tables_equal_jax(pair, name):
    names = ["A_ret", "A_rc", "A_cc", "M_full", "B_loc", "Acc_inv", "A_cond"]
    i = names.index(name)
    key, i = ("tabs3d", i) if i < 5 else ("cond", i - 5)
    got = pair["own_cache"][key][i]
    want = pair["cache"][key][i]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_own_dofs_free_mask_and_boundary_values_equal_jax(pair):
    mj, own = pair["mj"], pair["own"]
    np.testing.assert_array_equal(own.Xv.element_dofs,
                                  np.asarray(mj.Xv.element_dofs))
    np.testing.assert_array_equal(own.Q.element_dofs, mj.Q.element_dofs)
    np.testing.assert_array_equal(own.free.numpy(), np.asarray(mj.free))
    np.testing.assert_array_equal(own.u_bc.numpy(), np.asarray(mj.u_bc))
    assert (own.n, own.Q.ndof) == (mj.n, mj.Q.ndof)
    d_own, d_jax = own._diag_Mp, np.asarray(mj._diag_Mp)
    assert np.abs(d_own - d_jax).max() <= 1e-14 * np.abs(d_jax).max()


def test_face_block_layout_equals_jax(pair):
    lj, lp = pair["mj"].fb, pair["mp"].fb
    np.testing.assert_array_equal(lp.perm, lj.perm)
    np.testing.assert_array_equal(lp.perm_skel, lj.perm_skel)
    np.testing.assert_array_equal(lp.pos.numpy(), np.asarray(lj.pos))
    u = np.random.default_rng(0).standard_normal(lp.n)
    uFj, uij = lj.split(jnp.asarray(u))
    uFp, uip = lp.split(torch.from_numpy(u))
    np.testing.assert_array_equal(uFp.numpy(), np.asarray(uFj))
    np.testing.assert_array_equal(uip.numpy(), np.asarray(uij))
    np.testing.assert_array_equal(lp.join(uFp, uip).numpy(), u)
    ue_p = lp.gather_elem(uFp, uip)
    np.testing.assert_array_equal(ue_p.numpy(),
                                  np.asarray(lj.gather_elem(uFj, uij)))
    yFj, yij = lj.scatter_elem(jnp.asarray(ue_p.numpy()))
    yFp, yip = lp.scatter_elem(ue_p)
    np.testing.assert_array_equal(yFp.numpy(), np.asarray(yFj))
    np.testing.assert_array_equal(yip.numpy(), np.asarray(yij))


def test_face_transfer_matches_jax(pair):
    """The P1 face transfer TF / TFt (f32 tables and vectors, as on the
    main path): 1e-6 relative, f32 sums in another order."""
    mp, mj = pair["mp"], pair["mj"]
    TFj, TFtj = jax_face_transfer(mj.Xv, mj.fb, jnp.float32)
    TFp, TFtp = hybrid_h1_face_transfer(mp.Xv, mp.fb, torch.float32)
    rng = np.random.default_rng(1)
    z = rng.standard_normal((mp.mesh.nv, 3)).astype(np.float32)
    rF = rng.standard_normal((mp.fb.nface, mp.fb.nfb)).astype(np.float32)
    assert _rel(np.asarray(TFj(jnp.asarray(z))),
                TFp(torch.from_numpy(z)).numpy()) <= 1e-6
    assert _rel(np.asarray(TFtj(jnp.asarray(rF))),
                TFtp(torch.from_numpy(rF)).numpy()) <= 1e-6


@pytest.mark.parametrize("op", ["A", "B", "BT", "A_raw", "B_raw"])
def test_f64_operators_from_jax_tables_match(pair, op):
    mj, mp = pair["mj"], pair["mp"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal(mp.Q.ndof if op == "BT" else mp.n)
    want = np.asarray(getattr(mj, op)(jnp.asarray(x)))
    got = getattr(mp, op)(torch.from_numpy(x)).numpy()
    assert _rel(want, got) <= 1e-13


def test_equilibration_scaling_equals_jax(pair):
    np.testing.assert_array_equal(pair["solver"].D.numpy(),
                                  np.asarray(pair["Dj"]))


@pytest.mark.parametrize("op", ["A", "B", "BT", "preA", "preM"])
def test_split_f32_operators_match_jax(pair, op):
    mp = pair["mp"]
    rng = np.random.default_rng(3)
    n = mp.Q.ndof if op in ("BT", "preM") else mp.n
    x = rng.standard_normal(n).astype(np.float32)
    want = np.asarray(pair["ops32j"][op](jnp.asarray(x)))
    got = pair["solver"].ops32[op](torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _rel(want, got.numpy()) <= 1e-5


@pytest.mark.parametrize("op", ["A", "B", "BT"])
def test_compensated_operators_match_jax(pair, op):
    mp = pair["mp"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal(mp.Q.ndof if op == "BT" else mp.n)
    want = np.asarray(pair["odsj"][op](jnp.asarray(x)))
    got = pair["solver"].ops_ds[op](torch.from_numpy(x))
    assert got.dtype == torch.float64
    assert _rel(want, got.numpy()) <= 1e-12


def test_minres_error_history_matches_jax(pair):
    """30 preconditioned MINRES iterations on the equilibrated split-f32
    saddle system, from the same f32 right-hand side."""
    s, o32j = pair["solver"], pair["ops32j"]
    r0 = (s.D * s.f_mod).to(torch.float32)
    r1 = s.g_mod.to(torch.float32)

    def Kj(x):
        return (o32j["A"](x[0]) + o32j["BT"](x[1]), o32j["B"](x[0]))

    def prej(x):
        return (o32j["preA"](x[0]), o32j["preM"](x[1]))

    steps = 30
    resj = jax_minres(Kj, (jnp.asarray(r0.numpy()), jnp.asarray(r1.numpy())),
                      pre=prej, maxsteps=steps, tol=1e-12, abs_test=False)
    resp = minres(s.K32, (r0, r1), pre=s.pre32, maxsteps=steps, tol=1e-12,
                  abs_test=False)
    ej = np.asarray(resj.errors, np.float64)
    ep = np.asarray(resp.errors, np.float64)
    assert resp.iterations == int(resj.iterations) == steps
    assert np.all(ep[1:] < 1.0) and ep[-1] < ep[1]
    np.testing.assert_allclose(ep[:steps + 1], ej[:steps + 1], rtol=1e-4)


def test_flagship_solve_control_flow_at_loose_tolerance(pair, monkeypatch):
    """The refinement driver end to end on the CPU, cut to a tolerance of
    0.5 and MINRES chunks of 20 iterations (the 1e-8 solve runs on the card
    in chip_smoke.py): the per-pass residuals through the compensated
    operators agree with the true f64 residual, which meets the
    tolerance."""
    import navier_stokes_tpu_torch.flagship as flagship

    monkeypatch.setattr(flagship, "CHUNK32", 20)
    s = FlagshipSolve(pair["mp"], tol=0.5, gs=False)
    res = s.full_solve()
    assert 0 < res.inner <= 60
    assert res.true_rel <= 0.5
    assert abs(res.rel - res.true_rel) <= 1e-10
    assert res.log[0].startswith("p1 pass 0")
    u, p = res.x
    assert u.shape == (pair["mp"].n,) and p.shape == (pair["mp"].Q.ndof,)


def test_elem_apply_multi_equals_split_stream(pair):
    """``elem_apply_multi`` (one block_mv per table, summed) computes the
    same split operator as the one-stream ``block_mv2`` apply: 1e-6."""
    mp, s = pair["mp"], pair["solver"]
    hi, lo = s.ops32["A"].tables
    multi = mp.fb.elem_apply_multi([(hi, None), (lo, None)])
    x = torch.from_numpy(
        np.random.default_rng(6).standard_normal(mp.n).astype(np.float32))
    x = torch.where(mp.free, x, 0.0)
    want = torch.where(mp.free, multi(x), x)
    assert _rel(want.numpy(), s.ops32["A"](x).numpy()) <= 1e-6


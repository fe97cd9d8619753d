"""Parity of the port's default flagship configuration -- the order-3 curved
cylinder and the symmetric multicolor block-GS skeleton preconditioner --
with the JAX package on ``channel_with_cylinder_mesh_3d(0.6)``, order 2,
nu = 1e-3.

The JAX side runs ``equilibrated_f32_ops(gs=True, split=True, with_ds=True)``
on the CPU with bench.py's settings as environment (``NSTPU_SMOOTHER_BF16=
ext,inv``, ``NSTPU_COARSE_TARGET=1.6``) and its host-table derivation
(``NSTPU_DEVICE_TABLES=0``); the port takes the same settings as arguments
(their defaults) and builds from the JAX model's curved host tables.
Tolerances:

* curved host tables and condensation: EQUAL (the same numpy operations in
  the same order);
* edge-star blocks in bucket order and their colors: EQUAL;
* each color's GS solve segments put back into the padded layout: EQUAL
  to the merged padded table of the same inverses (the JAX layout);
* the coarse damping: lambda and theta to 1e-5 relative (an f32 power
  iteration, sums in another order);
* the row-panel sweep against the recompute sweep (a full S apply before
  every color), both in f64: 1e-10 relative;
* preA32 against the JAX preA32: 2e-5 relative in norm -- f32 arithmetic
  through the 18 color steps of the sweep, summed in different orders, on
  tables stored in bf16 on both sides: the extension tables and the GS
  color-solve inverses, rounded from f64 inverses that the two packages
  compute in different orders;
* symmetry of the GS preA with f32-stored tables applied in f64: 1e-8 of
  the product's size, as tests/test_skeleton_fast.py:57-61;
* the first 30 MINRES error-history entries: 1e-4 relative to the JAX
  package's MINRES in f64 arithmetic on its own stored tables, and no
  further from it than the JAX package's own f32 run (see the test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import navier_stokes_tpu.precond.multicolor as jax_multicolor
from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.mesh.curved import curve_to_cylinder_3d
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
from navier_stokes_tpu.solvers.minres import minres as jax_minres
from navier_stokes_tpu.solvers.refinement import (
    equilibrated_f32_ops as jax_equilibrated_f32_ops,
)
from navier_stokes_tpu_torch.flagship import FlagshipSolve, build_model, uin
from navier_stokes_tpu_torch.models import load_host_tables
from navier_stokes_tpu_torch.models.auxspace3d import (
    build_skeleton_preconditioner_3d,
)
from navier_stokes_tpu_torch.ops.faceblock import face_star_smoother
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
    mesh = channel_with_cylinder_mesh_3d(MAXH)
    geo = curve_to_cylinder_3d(mesh, "cyl", (0.5, 0.2), 0.05, order=3)
    cache = {}
    mj = NavierStokesMCS(
        mesh, nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=uin, timestep=2e-3, order=2, geometry=geo, assembly_cache=cache)
    own_cache = {}
    own = build_model(MAXH, device="cpu", assembly_cache=own_cache)
    mp = build_model(MAXH, device="cpu", assembly_cache=load_host_tables(
        {f"{key}_{i}": a for key, tup in cache.items()
         for i, a in enumerate(tup)}))
    seen = {}
    color_blocks = jax_multicolor.color_blocks
    damped_coarse = jax_multicolor.damped_coarse

    def record_colors(*a, **k):
        seen["colors"] = color_blocks(*a, **k)
        return seen["colors"]

    def record_damping(*a, **k):
        out = damped_coarse(*a, **k)
        seen["lam"], seen["theta"] = out[1], out[2]
        return out

    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("NSTPU_SMOOTHER_BF16", "ext,inv")
        mpatch.setenv("NSTPU_DEVICE_TABLES", "0")
        mpatch.setenv("NSTPU_COARSE_TARGET", "1.6")
        mpatch.setattr(jax_multicolor, "color_blocks", record_colors)
        mpatch.setattr(jax_multicolor, "damped_coarse", record_damping)
        ops32j, Dj, odsj = jax_equilibrated_f32_ops(
            mj, gs=True, split=True, with_ds=True)
    solver = FlagshipSolve(mp)
    return dict(mj=mj, own=own, own_cache=own_cache, mp=mp, cache=cache,
                geo=geo, ops32j=ops32j, seen=seen, solver=solver)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.mark.parametrize("name", [
    "A_ret", "A_rc", "A_cc", "M_full", "B_loc", "Acc_inv", "A_cond"])
def test_curved_host_tables_equal_jax(pair, name):
    names = ["A_ret", "A_rc", "A_cc", "M_full", "B_loc", "Acc_inv", "A_cond"]
    i = names.index(name)
    key, i = ("tabs3d_curved", i) if i < 5 else ("cond_curved", i - 5)
    got = pair["own_cache"][key][i]
    want = pair["cache"][key][i]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_curved_geometry_equals_jax(pair):
    geo_p, geo_j = pair["own"].geometry, pair["geo"]
    assert len(geo_p.curved_elements) == 134  # maxh=0.6 (bench: 335 at 0.09)
    np.testing.assert_array_equal(geo_p.curved_elements,
                                  geo_j.curved_elements)
    np.testing.assert_array_equal(geo_p.coords, geo_j.coords)


def test_gs_blocks_and_colors_equal_jax(pair):
    smj = pair["ops32j"]["preA"].parts["smoother"]
    parts = pair["solver"].ops32["preA"].parts
    assert len(parts["smoother"].block_faces) == len(smj.block_faces)
    for fp, fj in zip(parts["smoother"].block_faces, smj.block_faces):
        np.testing.assert_array_equal(fp, fj)
    np.testing.assert_array_equal(parts["colors"], pair["seen"]["colors"])
    assert len(parts["groups"]) == int(parts["colors"].max()) + 1 == 9


def test_coarse_damping_matches_jax(pair):
    parts = pair["solver"].ops32["preA"].parts
    assert abs(parts["coarse_lambda"] / pair["seen"]["lam"] - 1) <= 1e-5
    assert abs(parts["coarse_theta"] / pair["seen"]["theta"] - 1) <= 1e-5
    assert 0 < parts["coarse_theta"] < 1


def _schur_f64(m):
    """Face-major f64 skeleton Schur complement of the model's condensed
    operator (tests/test_skeleton_fast.py:120-190)."""
    V = m.Xv
    nbv = V.hdiv.n_basis
    n_face_tot = 4 * V.hdiv.n_face_dofs
    loc_int = np.arange(n_face_tot, nbv)
    loc_skel = np.concatenate([np.arange(n_face_tot),
                               np.arange(nbv, nbv + 4 * V.facet.n_face)])
    A = m.A_cond_np
    A_ii = A[:, loc_int[:, None], loc_int[None, :]]
    A_is = A[:, loc_int[:, None], loc_skel[None, :]]
    A_ss = A[:, loc_skel[:, None], loc_skel[None, :]]
    S = A_ss - np.matmul(A_is.transpose(0, 2, 1),
                         np.matmul(np.linalg.inv(A_ii), A_is))
    return m.fb.permute_skel_blocks(S)


def test_row_panel_sweep_matches_recompute_sweep_f64(pair):
    """The row-panel sweep (each color's residual from row panels of S)
    is algebraically the recompute sweep (a full S apply before every
    color) with the same colors: parity to f64 roundoff."""
    m = pair["mp"]
    lay = m.fb
    S_perm = _schur_f64(m)
    f64 = torch.float64
    sm = face_star_smoother(lay, m.Xv.free_mask, compute_dtype=f64)
    S5p = sm.skeleton_table(S_perm)
    groups = sm.color_row_groups(
        pair["solver"].ops32["preA"].parts["colors"], S5p,
        sm.bucket_inverses(S5p), f64, f64)
    S_t = torch.from_numpy(S_perm)
    freeF = sm.freeF

    def S_faces(xF):
        xF = torch.where(freeF, xF, 0.0)
        ye = torch.einsum("eij,ej->ei", S_t, lay.gather_skel(xF))
        return torch.where(freeF, lay.scatter_skel(ye), 0.0)

    def pad(xF):
        return torch.cat([xF, xF.new_zeros((1, lay.nfb))])

    rng = np.random.default_rng(3)
    xF = torch.from_numpy(rng.standard_normal((lay.nface, lay.nfb))) * freeF
    y_old = torch.zeros_like(xF)
    for g in groups + groups[::-1]:
        r = xF - S_faces(y_old)
        y_old = y_old + sm.solve_color_rows(g, pad(r))[:-1]
    xP = pad(xF)
    y = None
    for g in groups:
        dy = sm.solve_color_rows(g, xP, y)
        y = dy if y is None else y + dy
    for g in groups[::-1]:
        y = y + sm.solve_color_rows(g, xP, y)
    assert float(y[-1].abs().max()) == 0.0  # the pad row stays zero
    assert _rel(y_old.numpy(), y[:-1].numpy()) < 1e-10


def _padded_solve_tables(sm, colors, invs):
    """Per color, the merged padded solve table of the JAX package's layout
    (navier_stokes_tpu/ops/faceblock.py ``color_row_groups``): the color's
    edge-star inverses in bucket order, each zero-padded to the color's
    largest block, and one trailing zero block; f64."""
    nfb = sm.layout.nfb
    base = np.cumsum([0] + [len(f) for f in sm.faces_np])
    out = []
    for c in range(int(np.max(colors)) + 1):
        parts = []
        for bi, faces_b in enumerate(sm.faces_np):
            keep = np.where(colors[base[bi]: base[bi + 1]] == c)[0]
            if len(keep):
                parts.append((bi, keep, faces_b.shape[1] * nfb))
        bmax = max(d for _, _, d in parts)
        full = torch.zeros((sum(len(k) for _, k, _ in parts) + 1, bmax, bmax),
                           dtype=torch.float64)
        blk = 0
        for bi, keep, d in parts:
            full[blk: blk + len(keep), :d, :d] = \
                invs[bi][torch.as_tensor(keep)]
            blk += len(keep)
        out.append(full)
    return out


def test_gs_solve_segments_equal_padded_tables(pair):
    """color_row_groups stores each color's inverses by segment, without
    padding: put back into the padded layout they EQUAL the merged padded
    table (the JAX package's layout) built from the same inverses, in f32
    and bf16 storage, and the segments hold only the real blocks."""
    m = pair["mp"]
    sm = face_star_smoother(m.fb, m.Xv.free_mask)
    S5p = sm.skeleton_table(_schur_f64(m))
    invs = sm.bucket_inverses(S5p)
    colors = pair["solver"].ops32["preA"].parts["colors"]
    want = _padded_solve_tables(sm, colors, invs)
    for dt in (torch.float32, torch.bfloat16):
        groups = sm.color_row_groups(colors, S5p, invs, torch.float32, dt)
        assert len(groups) == len(want)
        for g, P in zip(groups, want):
            T = g.solve.table
            assert T.data.dtype == dt and (T.nblk, T.width) == P.shape[:2]
            assert torch.equal(T.padded(), P.to(dt))
            real = int((P.abs().sum(dim=2) > 0).sum(dim=1).pow(2).sum())
            assert T.real_bytes == real * T.data.element_size()
            assert T.data.numel() == real


def test_gs_preA32_matches_jax(pair):
    mp = pair["mp"]
    x = np.random.default_rng(3).standard_normal(mp.n).astype(np.float32)
    want = np.asarray(pair["ops32j"]["preA"](jnp.asarray(x)))
    got = pair["solver"].ops32["preA"](torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _rel(want, got.numpy()) <= 2e-5


def test_gs_preA_is_symmetric_with_f32_tables(pair):
    """f32-stored tables applied in f64 arithmetic are a fixed linear
    operator, and the symmetric sweep (reverse color order, the same
    damped coarse) makes it symmetric to f64 roundoff."""
    s, mp = pair["solver"], pair["mp"]
    D = s.D.numpy()
    De = D[np.asarray(mp.Xv.element_dofs)]
    A_s = mp.A_cond_np * De[:, :, None] * De[:, None, :]
    f32 = torch.float32
    pre = build_skeleton_preconditioner_3d(
        mp.Xv, A_s, mp._dirich, "cpu", torch.float64,
        coarse_coefficient=mp.nu, dof_scale=D, gs=True, ext_dtype=f32,
        inv_dtype=f32, panel_dtype=f32, sweep_dtype=f32)
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal(mp.n)) * mp.free
    b = torch.from_numpy(rng.standard_normal(mp.n)) * mp.free
    lhs = float(torch.dot(pre(a), b))
    rhs = float(torch.dot(a, pre(b)))
    assert abs(lhs - rhs) < 1e-8 * max(abs(lhs), 1.0)


def test_unsymmetrized_gs_preA32_matches_jax(pair):
    """``symmetrize=False`` stores the JAX package's tables as computed (the
    port's one deliberate departure switched off): preA32 against the JAX
    preA32 at the tolerance of :func:`test_gs_preA32_matches_jax`."""
    s, mp = pair["solver"], pair["mp"]
    D = s.D.numpy()
    De = D[np.asarray(mp.Xv.element_dofs)]
    pre = build_skeleton_preconditioner_3d(
        mp.Xv, mp.A_cond_np * De[:, :, None] * De[:, None, :], mp._dirich,
        "cpu", torch.float32, coarse_coefficient=mp.nu, dof_scale=D, gs=True,
        symmetrize=False)
    x = np.random.default_rng(3).standard_normal(mp.n).astype(np.float32)
    want = np.asarray(pair["ops32j"]["preA"](jnp.asarray(x)))
    assert _rel(want, pre(torch.from_numpy(x)).numpy()) <= 2e-5


def test_gs_minres_error_history_matches_jax(pair):
    """30 preconditioned MINRES iterations on the equilibrated split-f32
    saddle system with the GS preconditioner, from the same f32
    right-hand side, against the JAX package's witness: its MINRES in f64
    arithmetic on its own stored tables (its preA32 applied to f64
    vectors, its model's f64 operator).

    The port's f32 run is held to 1e-4 of the witness, and to no more
    drift from it than the JAX package's own f32 run, with its symmetrized
    tables and with the reference's (``symmetrize=False``).  The drifts
    are printed (``pytest -s``): the JAX f32 run's is the largest, so the
    symmetrization is not what separates the two f32 runs."""
    s, o32j, mp, mj = pair["solver"], pair["ops32j"], pair["mp"], pair["mj"]
    r0 = (s.D * s.f_mod).to(torch.float32)
    r1 = s.g_mod.to(torch.float32)

    def Kj(x):
        return (o32j["A"](x[0]) + o32j["BT"](x[1]), o32j["B"](x[0]))

    def prej(x):
        return (o32j["preA"](x[0]), o32j["preM"](x[1]))

    Dj = jnp.asarray(s.D.numpy())

    def Kj64(x):
        return (Dj * mj.A(Dj * x[0]) + Dj * mj.BT(x[1]), mj.B(Dj * x[0]))

    def prej64(x):
        y = o32j["preA"](x[0])
        assert y.dtype == jnp.float64  # f64 arithmetic on the f32/bf16 tables
        return (y, o32j["preM"](x[1].astype(jnp.float32)).astype(jnp.float64))

    steps = 30
    rhs = (r0.numpy(), r1.numpy())
    resj = jax_minres(Kj, tuple(jnp.asarray(r) for r in rhs), pre=prej,
                      maxsteps=steps, tol=1e-12, abs_test=False)
    resj64 = jax_minres(Kj64, tuple(jnp.asarray(r, jnp.float64) for r in rhs),
                        pre=prej64, maxsteps=steps, tol=1e-12, abs_test=False)
    resp = minres(s.K32, (r0, r1), pre=s.pre32, maxsteps=steps, tol=1e-12,
                  abs_test=False)
    D = s.D.numpy()
    De = D[np.asarray(mp.Xv.element_dofs)]
    pre_ref = build_skeleton_preconditioner_3d(
        mp.Xv, mp.A_cond_np * De[:, :, None] * De[:, None, :], mp._dirich,
        "cpu", torch.float32, coarse_coefficient=mp.nu, dof_scale=D, gs=True,
        symmetrize=False)
    resr = minres(s.K32, (r0, r1), maxsteps=steps, tol=1e-12, abs_test=False,
                  pre=lambda x: (pre_ref(x[0]), s.ops32["preM"](x[1])))
    ej, ej64, ep, er = (np.asarray(r.errors, np.float64)[:steps + 1]
                        for r in (resj, resj64, resp, resr))
    assert resp.iterations == int(resj.iterations) == steps
    assert np.all(ep[1:] < 1.0) and ep[-1] < ep[1]
    drift = {name: float(np.max(np.abs(e / ej64 - 1))) for name, e in
             (("port", ep), ("port, symmetrize=False", er), ("JAX f32", ej))}
    print(f"drift from the JAX f64 witness over {steps} iterations: "
          + ", ".join(f"{k} {v:.3e}" for k, v in drift.items()))
    for e in (ep, er):
        np.testing.assert_allclose(e, ej64, rtol=1e-4)
    assert max(drift["port"], drift["port, symmetrize=False"]) \
        <= drift["JAX f32"]


def test_gs_flagship_solve_control_flow_at_loose_tolerance(pair, monkeypatch):
    """The refinement driver end to end on the default configuration, cut
    to a tolerance of 0.5 and MINRES chunks of 5 iterations (the 1e-8
    solve runs on the card in chip_smoke.py)."""
    import navier_stokes_tpu_torch.flagship as flagship

    monkeypatch.setattr(flagship, "CHUNK32", 5)
    s = pair["solver"]
    s.tol = 0.5
    try:
        res = s.full_solve()
    finally:
        s.tol = 1e-8
    assert 0 < res.inner <= 15
    assert res.true_rel <= 0.5
    assert abs(res.rel - res.true_rel) <= 1e-10
    assert res.log[0].startswith("p1 pass 0")
    u, p = res.x
    assert u.shape == (pair["mp"].n,) and p.shape == (pair["mp"].Q.ndof,)

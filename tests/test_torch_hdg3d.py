"""Parity of the port's 3D HDG Navier-Stokes model (``NavierStokesHDG3D``)
and the modules under it with the JAX package, on the CPU, one torch
thread.

Meshes: the JAX smoke test's box (tests/test_ns_hdg3d.py:60-85: 0.5 x 1 x
1, 24 tets, n = 1,296 velocity and 96 pressure dofs, nu = 0.01) and the plates of
tests/test_hdiv3d.py (Poiseuille between plates).  The port's models are
built from their own host assembly on a copy of the JAX mesh.

Tolerances and what is held equal:

* ``assemble_hdg_stokes_3d`` tables, the mass table and the force load:
  1e-12 relative (the same numpy operations);
* ``u_bc``, free masks and dof tables: equal; the pressure-mass diagonal
  (``ops.assembly.mass_diagonal``) within 1e-14 of the JAX package's
  ``diagonal_of_local(mass_local(make_tables(Q, 2 max(order, 1))))``;
* T / T^T of the vector-P1 embedding, the auxspace preconditioner additive
  and multicolor GS, every operator of the model: 1e-12 relative;
* the vertex-star block inverses taken by torch in f64 (the route the
  card takes, ``precond.jacobi.block_inverses``) against the JAX
  package's numpy inverses: 1e-12 of the largest entry;
* ``SolveInitial`` with the JAX Bramble-Pasciak k: the same count (+-1),
  u and p within 1e-8 relative; ``Project`` leaves ||B u|| < 1e-7; one
  SIMPLE step from the JAX solution with the JAX Chebyshev bounds within
  1e-8 of the JAX step;
* ``build_hybrid_stokes_system_3d`` on the plates: the direct solve
  reproduces Poiseuille flow to 1e-8 (tests/test_hdiv3d.py:108);
* ``rt_tet``: the face-moment delta property and the RT_k dimension
  (tests/test_hdiv3d.py:157), and the RT0 space.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.fem.quadrature import tetrahedron_rule
from navier_stokes_tpu.linalg.lanczos import (
    lanczos_eigenvalues as jax_lanczos,
)
from navier_stokes_tpu.mesh.generators import extrude_to_tets, rectangle_mesh
from navier_stokes_tpu.models.auxspace3d import (
    build_auxspace_preconditioner_3d as jax_auxspace,
)
from navier_stokes_tpu.models.auxspace3d import (
    hybrid_h1_embedding_3d as jax_embedding,
)
from navier_stokes_tpu.models.navier_stokes_hdg3d import (
    NavierStokesHDG3D as JaxHDG3D,
)
from navier_stokes_tpu.models.stokes_hybrid3d import (
    assemble_hdg_stokes_3d as jax_assemble,
)
from navier_stokes_tpu.models.stokes_hybrid3d import (
    hybrid_blocks_3d as jax_hybrid_blocks_3d,
)
from navier_stokes_tpu.ops import assembly as jax_asm
from navier_stokes_tpu.precond.jacobi import (
    extract_blocks_from_local as jax_extract_blocks,
)
from navier_stokes_tpu.solvers.bpcg import bp_scale_factor as jax_bp_scale
from navier_stokes_tpu_torch.fem.hdiv3d import HDiv3D, face_frame, rt_tet
from navier_stokes_tpu_torch.fem.quadrature import triangle_rule
from navier_stokes_tpu_torch.fem.reference import triangle_modal
from navier_stokes_tpu_torch.mesh.mesh import Mesh
from navier_stokes_tpu_torch.models import NavierStokesHDG3D
from navier_stokes_tpu_torch.models.auxspace3d import (
    build_auxspace_preconditioner_3d,
    hybrid_h1_embedding_3d,
)
from navier_stokes_tpu_torch.models.stokes import StokesSystem
from navier_stokes_tpu_torch.models.stokes_hybrid3d import (
    assemble_hdg_stokes_3d,
    bdm_hybrid_3d,
    build_hybrid_stokes_system_3d,
    free_blocks,
)
from navier_stokes_tpu_torch.ops.assembly import assemble_csr, mass_diagonal
from navier_stokes_tpu_torch.precond.jacobi import (
    block_inverses,
    padded_blocks,
)
from navier_stokes_tpu_torch.scripts import navier_stokes_3d as demo

BOX_KW = dict(nu=0.01, inflow="inlet", outflow="outlet", wall="wall",
              timestep=2e-3, order=2)


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


def _port_mesh(jmesh):
    return Mesh(jmesh.points.copy(), jmesh.elements.copy(),
                {k: np.asarray(v).copy()
                 for k, v in jmesh.boundary_tags.items()})


def box_mesh():
    """tests/test_ns_hdg3d.py:test_ns_hdg3d_smoke's mesh."""
    base = rectangle_mesh(0.5, 1.0, 1.0)
    mesh = extrude_to_tets(base, np.linspace(0, 0.5, 2))
    tol = 1e-9
    mesh.tag_boundary_by_predicate("inlet",
                                   lambda p: np.abs(p[:, :, 0]) < tol)
    mesh.tag_boundary_by_predicate(
        "outlet", lambda p: np.abs(p[:, :, 0] - 1.0) < tol)
    rest = np.setdiff1d(mesh.boundary_facets, np.concatenate(
        [mesh.boundary_tags["inlet"], mesh.boundary_tags["outlet"]]))
    mesh.boundary_tags["wall"] = rest.astype(np.int32)
    return mesh


def box_uin(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = (16 * p[:, 1] * (1 - p[:, 1]) * p[:, 2] * (0.5 - p[:, 2])
                 / 0.25)
    return out


def _jax_cheb_bounds(mj):
    """The (alpha, beta) of the JAX model's Chebyshev mass inverse
    (chebyshev.py:40-43, 30 Lanczos steps from its fixed start vector)."""
    lams = jax_lanczos(mj._Mv, mj._preMv, mj.u_bc, 30)
    beta = 1.05 * float(jnp.max(lams))
    return 0.02 * beta, beta


@pytest.fixture(scope="module")
def box(one_torch_thread):
    jmesh = box_mesh()
    mj = JaxHDG3D(jmesh, uin=box_uin, **BOX_KW)
    mp = NavierStokesHDG3D(_port_mesh(jmesh), uin=box_uin, device="cpu",
                           **BOX_KW)
    f_mod = jnp.where(mj.free, mj.f - mj.A_raw(mj.u_bc), 0.0)
    k, _ = jax_bp_scale(mj.A, mj.preA, f_mod)
    res_j = mj.SolveInitial(iterative=True, tol=1e-9, maxsteps=60000)
    res_p = mp.SolveInitial(iterative=True, tol=1e-9, maxsteps=60000,
                            scale_k=float(k))
    return dict(mj=mj, mp=mp, jmesh=jmesh, k=float(k), res_j=res_j,
                res_p=res_p)


def test_hdg_tables_equal_jax(box):
    mj, mp = box["mj"], box["mp"]
    A_j, B_j, force_j, _, _ = jax_assemble(mj.Xv, mj.Q, alpha=10.0,
                                           nu=mj.nu)
    A_p, B_p, force_p, _, _ = assemble_hdg_stokes_3d(mp.Xv, mp.Q,
                                                     alpha=10.0, nu=mp.nu)
    assert A_p.shape == (24, 78, 78) and B_p.shape == A_j.shape[:1] + (
        B_j.shape[1], 78)
    assert _rel(A_j, A_p) <= 1e-12 and _rel(B_j, B_p) <= 1e-12
    assert _rel(force_j(box_uin), force_p(box_uin)) <= 1e-12
    np.testing.assert_array_equal(mp.A_np, A_p)  # the model's own tables


def test_hdg_dofs_boundary_values_and_pressure_mass_equal_jax(box):
    mj, mp = box["mj"], box["mp"]
    assert (mp.n, mp.Q.ndof) == (mj.n, mj.Q.ndof) == (1296, 96)
    np.testing.assert_array_equal(mp.Xv.element_dofs,
                                  np.asarray(mj.Xv.element_dofs))
    np.testing.assert_array_equal(mp.free.numpy(), np.asarray(mj.free))
    np.testing.assert_array_equal(mp.u_bc.numpy(), np.asarray(mj.u_bc))
    tq = jax_asm.make_tables(mj.Q, 2 * max(mj.Q.order, 1), jnp.float64)
    d_jax = np.asarray(jax_asm.diagonal_of_local(jax_asm.mass_local(tq),
                                                 tq.eldofs, mj.Q.ndof))
    d_port = mass_diagonal(mp.Q)
    assert np.abs(d_port - d_jax).max() <= 1e-14 * np.abs(d_jax).max()


@pytest.mark.parametrize("name", ["A", "A_raw", "mstar", "B", "B_raw",
                                  "preA", "_Mv", "preMstar", "_preMv",
                                  "convection", "BT", "preM"])
def test_hdg_operators_match_jax(box, name):
    mj, mp = box["mj"], box["mp"]
    rng = np.random.default_rng(7)
    n = mp.Q.ndof if name in ("BT", "preM") else mp.n
    x = rng.standard_normal(n)
    want = np.asarray(getattr(mj, name)(jnp.asarray(x)))
    got = getattr(mp, name)(torch.from_numpy(x)).numpy()
    assert _rel(want, got) <= 1e-12


def test_embedding_matches_jax(box):
    mj, mp = box["mj"], box["mp"]
    Tj, TTj = jax_embedding(mj.Xv)
    Tp, TTp = hybrid_h1_embedding_3d(mp.Xv, device="cpu")
    rng = np.random.default_rng(1)
    c = rng.standard_normal(3 * mp.mesh.nv)
    x = rng.standard_normal(mp.n)
    assert _rel(Tj(jnp.asarray(c)), Tp(torch.from_numpy(c)).numpy()) <= 1e-12
    assert _rel(TTj(jnp.asarray(x)),
                TTp(torch.from_numpy(x)).numpy()) <= 1e-12
    # the transpose is exact
    lhs = float(torch.dot(Tp(torch.from_numpy(c)), torch.from_numpy(x)))
    rhs = float(torch.dot(torch.from_numpy(c), TTp(torch.from_numpy(x))))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("gs", [False, True])
def test_auxspace_preconditioner_matches_jax(box, gs):
    mj, mp = box["mj"], box["mp"]
    kw = dict(coarse_coefficient=mj.nu, gs=gs)
    pre_j = jax_auxspace(mj.Xv, mp.A_np, "inlet|wall", jnp.float64,
                         A_apply=mj.A if gs else None, **kw)
    pre_p = build_auxspace_preconditioner_3d(
        mp.Xv, mp.A_np, mp._dirich, torch.float64, device="cpu",
        A_apply=mp.A if gs else None, **kw)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(mp.n)
    assert _rel(pre_j(jnp.asarray(x)), pre_p(torch.from_numpy(x)).numpy()) \
        <= 1e-12


def test_block_inverses_on_torch_equal_numpy(box):
    """The vertex-star inverses as the card takes them (extracted and
    inverted by torch in f64) against the JAX package's numpy route."""
    mp = box["mp"]
    V = mp.Xv
    fmask = V.free_mask
    blks_j = [np.asarray([d for d in b if fmask[d]], np.int32)
              for b in jax_hybrid_blocks_3d(V, "vertexstar")]
    blks_j = [b for b in blks_j if len(b)]
    dofs_j, mats_j = jax_extract_blocks(mp.A_np, V.element_dofs, blks_j,
                                        V.ndof)
    inv_j = np.linalg.inv(mats_j)
    dofs_p = padded_blocks(free_blocks(V, "vertexstar"))
    np.testing.assert_array_equal(dofs_p, dofs_j)
    A = assemble_csr(mp.A_np, V.element_dofs, V.ndof)
    inv_p = block_inverses(A, dofs_p, torch.float64, "cpu",
                           chunk_entries=2 * dofs_p.shape[1] ** 2).numpy()
    assert dofs_p.shape == (18, 456)
    assert np.abs(inv_p - inv_j).max() <= 1e-12 * np.abs(inv_j).max()
    # f32 storage rounds the blocks first, as the JAX model's f32 twin does
    inv32 = block_inverses(A, dofs_p, torch.float32, "cpu").numpy()
    want32 = np.linalg.inv(mats_j.astype(np.float32).astype(np.float64)
                           ).astype(np.float32)
    assert np.abs(inv32 - want32).max() <= 1e-6 * np.abs(want32).max()


def test_solve_initial_matches_jax(box):
    mj, mp = box["mj"], box["mp"]
    it_j, it_p = int(box["res_j"].iterations), mp.stokes_bpcg_iterations
    assert abs(it_p - it_j) <= 1
    assert box["res_p"].converged
    assert mp.stokes_bpcg_scale_k == pytest.approx(box["k"], rel=1e-15)
    assert mp.stokes_bpcg_time > 0
    assert _rel(mj.u, mp.u.numpy()) <= 1e-8
    assert _rel(mj.p, mp.p.numpy()) <= 1e-8
    np.testing.assert_array_equal(mp.velocity, mp.u[: mp.Xv.hdiv.ndof])
    np.testing.assert_array_equal(mp.pressure, -mp.p.numpy())


def test_project_leaves_divergence_free(box):
    mp = box["mp"]
    u = mp.u.clone()
    assert float(torch.linalg.norm(mp.B_raw(u))) < 1e-4
    v = mp.Project(vel=u)
    assert float(torch.linalg.norm(mp.B_raw(v))) < 1e-7
    assert mp.last_iterations["project"] > 0


def test_time_step_matches_jax(box):
    mj, mp = box["mj"], box["mp"]
    u0 = np.asarray(mj.u)
    bounds = _jax_cheb_bounds(mj)
    mp.load_state(u=u0, p=np.asarray(mj.p), cheb_bounds=bounds)
    assert mp._mass_chebyshev().bounds == bounds
    want = np.asarray(jax.jit(mj.make_step_fn())(jnp.asarray(u0)))
    got = mp.make_step_fn()(mp.u).numpy()
    assert np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()
    assert np.abs(got - u0).max() > 1e-6 * np.abs(u0).max()  # it moved
    mp.DoTimeStep()
    np.testing.assert_array_equal(mp.u.numpy(), got)


def test_add_force_matches_jax(box):
    mj, mp = box["mj"], box["mp"]

    def force(p):
        return np.stack([np.sin(3 * p[:, 0]), p[:, 2], p[:, 0] * p[:, 1]],
                        axis=1)

    f_j0, f_p0 = np.asarray(mj.f), mp.f.clone()
    mj.AddForce(force)
    mp.AddForce(force)
    try:
        assert _rel(mj.f, mp.f.numpy()) <= 1e-13
    finally:
        mj.f, mp.f = jnp.asarray(f_j0), f_p0


def _plates_setup():
    base = rectangle_mesh(0.25, 1.0, 1.0)
    mesh = extrude_to_tets(base, np.linspace(0, 0.5, 3))
    mesh.tag_boundary_by_predicate(
        "outlet", lambda p: np.abs(p[:, :, 0] - 1.0) < 1e-9)
    rest = np.setdiff1d(mesh.boundary_facets, mesh.boundary_tags["outlet"])
    mesh.boundary_tags["diri"] = rest.astype(np.int32)

    def uin(p):
        out = np.zeros((len(p), 3))
        out[:, 0] = p[:, 1] * (1.0 - p[:, 1])
        return out

    return _port_mesh(mesh), uin


def test_hybrid_stokes_system_poiseuille_exact_direct(one_torch_thread):
    """tests/test_hdiv3d.py:test_hdg3d_poiseuille_exact_direct through the
    port's build_hybrid_stokes_system_3d."""
    mesh, uin = _plates_setup()
    disc, order = bdm_hybrid_3d(2)
    assert order == 2
    system = build_hybrid_stokes_system_3d(mesh, disc, "diri", uin=uin,
                                           device="cpu")
    assert isinstance(system, StokesSystem)
    V, Q = system.V, system.Q
    A_np, B_np, *_ = assemble_hdg_stokes_3d(V, Q)
    K = assemble_csr(A_np, V.element_dofs, V.ndof)
    Bg = sp.coo_matrix(
        (B_np.ravel(), (np.repeat(Q.element_dofs[:, :, None], B_np.shape[2],
                                  2).ravel(),
                        np.repeat(V.element_dofs[:, None, :], B_np.shape[1],
                                  1).ravel())),
        shape=(Q.ndof, V.ndof)).tocsr()
    idx = np.where(V.free_mask)[0]
    KK = sp.bmat([[K[idx][:, idx], Bg[:, idx].T], [Bg[:, idx], None]]
                 ).tocsc()
    rhs = np.concatenate([system.f.numpy()[idx], system.g.numpy()])
    sol = spla.spsolve(KK, rhs)
    du = np.zeros(V.ndof)
    du[idx] = sol[: len(idx)]
    u = system.lift(torch.from_numpy(du)).numpy()
    # the masked operators agree with the assembled ones on the solution
    Au = system.A(torch.from_numpy(du)).numpy()
    assert np.abs(Au[idx] - K[idx][:, idx] @ du[idx]).max() <= 1e-10 * (
        np.abs(Au).max())
    hd = V.hdiv
    q3 = tetrahedron_rule(6)
    vals_ref, _ = hd.tabulate_elements(q3.points)
    J, detJ, _ = mesh.element_jacobians
    val_p = np.einsum("ecA,eqiA->eqic", J, vals_ref) / detJ[:, None, None,
                                                            None]
    uq = np.einsum("eqic,ei->eqc", val_p, u[V.element_dofs[:, : hd.n_basis]])
    qpts = mesh.points[mesh.elements[:, 0]][:, None, :] + np.einsum(
        "eab,qb->eqa", J, q3.points)
    ex = qpts[..., 1] * (1.0 - qpts[..., 1])
    assert np.abs(uq[..., 0] - ex).max() < 1e-8
    assert np.abs(uq[..., 1:]).max() < 1e-8
    # preconditioners of both kinds are SPD on the free dofs
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(V.ndof) * V.free_mask)
    assert float(torch.dot(x, system.preA(x))) > 0
    p = torch.from_numpy(rng.standard_normal(Q.ndof))
    assert float(torch.dot(p, system.preM(p))) > 0


@pytest.mark.parametrize("order", [0, 1, 2])
def test_rt_tet_delta_and_dim(order):
    combo = ((0, 1, 2), (1, 0, 2), (2, 1, 0), (0, 2, 1))
    b = rt_tet(order, combo)
    k = order
    assert b.n_basis == (k + 1) * (k + 2) * (k + 3) // 2 + (k + 1) * (
        k + 2) // 2
    q2 = triangle_rule(2 * k + 4)
    fvals, _ = triangle_modal(q2.points, k)
    D = np.zeros((b.n_basis, 4 * b.n_face))
    for lf in range(4):
        origin, e1, e2, n = face_frame(combo[lf], lf)
        pts = (origin[None] + q2.points[:, :1] * e1[None]
               + q2.points[:, 1:2] * e2[None])
        vals, _ = b.tabulate(pts)
        vn = np.einsum("qnc,c->qn", vals, n)
        for j in range(b.n_face):
            D[:, lf * b.n_face + j] = np.einsum("q,q,qn->n", q2.weights,
                                                fvals[:, j], vn)
    expect = np.zeros_like(D)
    expect[: 4 * b.n_face] = np.eye(4 * b.n_face)
    assert np.abs(D - expect).max() < 1e-7


def test_rt0_space_reproduces_rt_fields():
    from navier_stokes_tpu_torch.mesh.generators import extrude_to_tets as ext

    base = rectangle_mesh(0.5, 1.0, 1.0)
    mesh = ext(_port_mesh(base), np.linspace(0, 1.0, 3))
    V = HDiv3D(mesh, 0, RT=True)
    assert V.ndof == mesh.nface  # one dof per face
    assert V.name == "RT0-3D"
    b = V.bases[0]
    q3 = tetrahedron_rule(4)
    vals, _ = b.tabulate(q3.points)
    G = np.einsum("q,qic,qjc->ij", q3.weights, vals, vals)
    f = np.stack([1 + 2 * q3.points[:, 0], 3 + 2 * q3.points[:, 1],
                  -1 + 2 * q3.points[:, 2]], axis=1)
    c = np.linalg.solve(G, np.einsum("q,qic,qc->i", q3.weights, vals, f))
    recon = np.einsum("qic,i->qc", vals, c)
    assert np.abs(recon - f).max() < 1e-8


def test_demo_refuses_taylor_hood(capsys, tmp_path, monkeypatch):
    """The demo refuses ``--th`` together with ``--hdg``; ``--th`` alone
    runs the port's Taylor-Hood model (here on a shortened channel)."""
    with pytest.raises(SystemExit) as exc:
        demo.main(["--th", "--hdg", "--device", "cpu"])
    assert exc.value.code == 2
    assert "exclude each other" in capsys.readouterr().err
    short = demo.channel_with_cylinder_mesh_3d
    monkeypatch.setattr(demo, "channel_with_cylinder_mesh_3d",
                        lambda maxh: short(maxh, length=0.6,
                                           circle_resolution=6))
    out = tmp_path / "th.npz"
    assert demo.main(["1", "0.6", "--th", "--device", "cpu", "--out",
                      str(out)]) == 0
    text = capsys.readouterr().out
    assert "BPCG iterations" in text and "ndofs: V=" in text
    state = np.load(out)
    assert state["velocity"].shape[0] == 3
    assert np.isfinite(state["velocity"]).all()

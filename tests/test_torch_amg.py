"""Parity of the port's ``precond/`` (SA-AMG, block-Jacobi, the P1
embedding, the coarse P1 solve and the two-level preconditioner) with the
JAX package's, on the same matrices.

Both packages build the AMG hierarchy on the host from the same scipy matrix
with the same seeds, so the V-cycle outputs agree to roundoff: 1e-10
relative in float64 (sums in another order), 1e-4 in float32.  The two-level
preconditioners are held to 1e-10 in float64, and preconditioned CG must
take the JAX package's iteration counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.fem.spaces import H1 as JaxH1
from navier_stokes_tpu.mesh import (
    channel_with_cylinder_mesh_3d as jax_mesh_3d,
)
from navier_stokes_tpu.ops import assembly as jax_asm
from navier_stokes_tpu.precond import amg as jax_amg
from navier_stokes_tpu.precond.jacobi import block_jacobi as jax_block_jacobi
from navier_stokes_tpu.precond.jacobi import (
    extract_blocks_from_local as jax_extract_blocks_from_local,
)
from navier_stokes_tpu.precond.jacobi import jacobi as jax_pointwise_jacobi
from navier_stokes_tpu.precond import twolevel as jax_twolevel
from navier_stokes_tpu.solvers.cg import cg as jax_cg
from navier_stokes_tpu_torch.fem.hdiv3d import HDiv3D
from navier_stokes_tpu_torch.fem.spaces import H1
from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu_torch.ops import assembly as asm
from navier_stokes_tpu_torch.ops.convection3d import (
    build_upwind_convection_3d,
)
from navier_stokes_tpu_torch.precond import amg, jacobi, twolevel
from navier_stokes_tpu_torch.solvers.cg import cg

MAXH = 0.35
DIRICHLET = "inlet|wall|cyl"
TOL = {"float64": 1e-10, "float32": 1e-4}


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
def p1():
    """The P1 stiffness of the 3D channel, from both packages' spaces."""
    space = H1(channel_with_cylinder_mesh_3d(MAXH), 1, dirichlet=DIRICHLET)
    K = asm.assemble_csr(asm.stiffness_local(space), space.element_dofs,
                         space.ndof)
    jspace = JaxH1(jax_mesh_3d(MAXH), 1, dirichlet=DIRICHLET)
    assert np.array_equal(space.element_dofs, jspace.element_dofs)
    assert np.array_equal(space.free_mask, jspace.free_mask)
    return space, jspace, K


@pytest.fixture(scope="module")
def p2():
    """An order-2 H1 space with its stiffness element matrices and masked
    operator, in both packages."""
    mesh = channel_with_cylinder_mesh_3d(0.6)
    space = H1(mesh, 2, dirichlet=DIRICHLET)
    K_loc = asm.stiffness_local(space)
    jspace = JaxH1(jax_mesh_3d(0.6), 2, dirichlet=DIRICHLET)
    assert np.array_equal(space.element_dofs, jspace.element_dofs)
    free = torch.from_numpy(space.free_mask)
    K_t = torch.from_numpy(K_loc)
    eld = torch.from_numpy(space.element_dofs.astype(np.int64))

    def A(u):
        uf = torch.where(free, u, 0.0)
        return torch.where(
            free, asm.apply_local_matrices(K_t, eld, space.ndof, uf), u)

    jfree = jnp.asarray(space.free_mask)
    K_j, eld_j = jnp.asarray(K_loc), jnp.asarray(jspace.element_dofs)

    def A_j(u):
        uf = jnp.where(jfree, u, 0.0)
        y = jax_asm.apply_local_matrices(K_j, eld_j, space.ndof, uf)
        return jnp.where(jfree, y, u)

    return space, jspace, K_loc, A, A_j


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("k", [None, 3])
def test_amg_vcycle_matches_jax(p1, dtype, k):
    space, _, K = p1
    free = space.free_mask
    assert free.sum() > 50
    ref = jax_amg.build_sa_amg(K, free, getattr(jnp, dtype), coarse_size=50)
    got = amg.build_sa_amg(K, free, getattr(torch, dtype), "cpu",
                           coarse_size=50)
    assert got.levels >= 1
    rng = np.random.default_rng(0)
    shape = (space.ndof,) if k is None else (space.ndof, k)
    r = (rng.standard_normal(shape)
         * (free if k is None else free[:, None])).astype(dtype)
    z = got(torch.from_numpy(r))
    assert z.dtype == getattr(torch, dtype) and tuple(z.shape) == shape
    assert _rel(z.numpy(), ref(jnp.asarray(r))) <= TOL[dtype]
    assert float(z[torch.from_numpy(~free)].abs().max()) == 0.0


def test_amg_is_symmetric_positive_and_preconditions_cg(p1):
    space, _, K = p1
    free = space.free_mask
    pre = amg.build_sa_amg(K, free, torch.float64, "cpu", coarse_size=50)
    rng = np.random.default_rng(1)
    x, y = (torch.from_numpy(rng.standard_normal(space.ndof) * free)
            for _ in range(2))
    a1, a2 = float(torch.dot(pre(x), y)), float(torch.dot(x, pre(y)))
    assert abs(a1 - a2) < 1e-10 * abs(a1)
    for _ in range(3):
        v = torch.from_numpy(rng.standard_normal(space.ndof) * free)
        assert float(torch.dot(v, pre(v))) > 0
    # PCG with either package's V-cycle takes the same iterations
    free_t = torch.from_numpy(free)
    Kff = torch.from_numpy(K.toarray())

    def A(u):
        return torch.where(free_t, Kff @ torch.where(free_t, u, 0.0), u)

    b = torch.from_numpy(rng.standard_normal(space.ndof) * free)
    res = cg(A, b, pre=pre, tol=1e-8, maxsteps=200)
    jfree, Kj = jnp.asarray(free), jnp.asarray(K.toarray())
    jpre = jax_amg.build_sa_amg(K, free, jnp.float64, coarse_size=50)
    jres = jax_cg(lambda u: jnp.where(jfree, Kj @ jnp.where(jfree, u, 0.0),
                                      u),
                  jnp.asarray(b.numpy()), pre=jpre, tol=1e-8, maxsteps=200)
    assert res.converged and res.iterations < 40
    assert res.iterations == int(jres.iterations)
    assert _rel(res.x.numpy(), jres.x) <= 1e-8


@pytest.mark.parametrize("dense_limit", [50, 5000])
def test_coarse_p1_solver_matches_jax(p1, dense_limit):
    """Above ``dense_limit`` the AMG V-cycle, below it the dense inverse."""
    space, jspace, _ = p1
    ref = jax_twolevel.coarse_p1_solver(jspace, 0.7, jnp.float64,
                                        dense_limit=dense_limit)
    got = twolevel.coarse_p1_solver(space, 0.7, torch.float64, "cpu",
                                    dense_limit=dense_limit)
    assert hasattr(got, "levels") == (dense_limit == 50)
    rng = np.random.default_rng(2)
    for shape in ((space.mesh.nv,), (space.mesh.nv, 3)):
        r = rng.standard_normal(shape)
        assert _rel(got(torch.from_numpy(r)).numpy(),
                    ref(jnp.asarray(r))) <= 1e-10


def test_block_jacobi_matches_jax(p2):
    space, _, K_loc, _, _ = p2
    blocks = twolevel.vertex_patch_blocks(space)
    jblocks = jax_twolevel.vertex_patch_blocks(p2[1])
    assert len(blocks) == len(jblocks)
    assert all(np.array_equal(a, b) for a, b in zip(blocks, jblocks))
    dofs, mats = jacobi.extract_blocks_from_local(
        K_loc, space.element_dofs, blocks, space.ndof)
    jdofs, jmats = jax_extract_blocks_from_local(
        K_loc, space.element_dofs, jblocks, space.ndof)
    assert np.array_equal(dofs, jdofs)
    np.testing.assert_allclose(mats, jmats, rtol=0, atol=1e-14)
    ref = jax_block_jacobi(jdofs, jnp.asarray(jmats), space.ndof)
    x = np.random.default_rng(3).standard_normal(space.ndof) * space.free_mask
    for dtype in ("float64", "float32"):
        got = jacobi.block_jacobi(dofs, mats, space.ndof,
                                  getattr(torch, dtype), "cpu")
        y = got(torch.from_numpy(x.astype(dtype)))
        assert y.dtype == getattr(torch, dtype)
        assert _rel(y.numpy(), ref(jnp.asarray(x))) <= TOL[dtype]
    d = np.random.default_rng(4).uniform(1.0, 2.0, space.ndof)
    free = space.free_mask
    for mask in (None, free):
        got = jacobi.jacobi(torch.from_numpy(d),
                            None if mask is None else torch.from_numpy(mask))
        ref_j = jax_pointwise_jacobi(jnp.asarray(d),
                                  None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(got(torch.from_numpy(x)).numpy(),
                                   np.asarray(ref_j(jnp.asarray(x))),
                                   rtol=1e-15, atol=0)


def test_p1_embedding_matches_jax_and_is_exact(p2):
    space, jspace, *_ = p2
    P, PT = twolevel.p1_embedding(space, torch.float64, "cpu")
    Pj, PTj = jax_twolevel.p1_embedding(jspace)
    rng = np.random.default_rng(5)
    c = rng.standard_normal(space.mesh.nv)
    x = rng.standard_normal(space.ndof)
    assert _rel(P(torch.from_numpy(c)).numpy(), Pj(jnp.asarray(c))) <= 1e-12
    assert _rel(PT(torch.from_numpy(x)).numpy(), PTj(jnp.asarray(x))) <= 1e-12
    lhs = float(torch.dot(P(torch.from_numpy(c)), torch.from_numpy(x)))
    rhs = float(torch.dot(torch.from_numpy(c), PT(torch.from_numpy(x))))
    assert abs(lhs - rhs) < 1e-10 * (1 + abs(lhs))
    # linears are reproduced in the fine space
    pts = space.mesh.points
    lin = lambda p: 1.0 + 2 * p[:, 0] - p[:, 1] + 0.5 * p[:, 2]
    u = P(torch.from_numpy(lin(pts))).numpy()
    assert np.abs(u - space.interpolate(lin)).max() < 1e-12


@pytest.mark.parametrize("smoother", ["patch", "jacobi"])
def test_two_level_preconditioner_matches_jax(p2, smoother):
    space, jspace, K_loc, A, A_j = p2
    free = space.free_mask
    ref = jax_twolevel.two_level_preconditioner(
        jspace, jnp.asarray(K_loc), coefficient=1.3, smoother=smoother)
    got = twolevel.two_level_preconditioner(
        space, K_loc, coefficient=1.3, smoother=smoother,
        dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal(space.ndof)  # constrained entries pass through
    assert _rel(got(torch.from_numpy(x)).numpy(), ref(jnp.asarray(x))) <= 1e-10
    xf, yf = (torch.from_numpy(rng.standard_normal(space.ndof) * free)
              for _ in range(2))
    assert float(torch.dot(xf, got(xf))) > 0
    assert abs(float(torch.dot(xf, got(yf)) - torch.dot(got(xf), yf))) < 1e-9
    # the same CG iteration count as the JAX package, and the same solution
    b = np.where(free, 1.0, 0.0)
    res = cg(A, torch.from_numpy(b), pre=got, tol=1e-10, maxsteps=2000)
    jres = jax_cg(A_j, jnp.asarray(b), pre=ref, tol=1e-10, maxsteps=2000)
    assert res.converged
    assert res.iterations == int(jres.iterations)
    assert _rel(res.x.numpy(), jres.x) <= 1e-8
    with pytest.raises(ValueError):
        twolevel.two_level_preconditioner(space, K_loc, smoother="ilu",
                                          device="cpu")


@pytest.mark.parametrize("entry", ["coarse_p1_solver", "convection",
                                   "build_sa_amg", "two_level", "p1_embedding",
                                   "block_jacobi"])
def test_entry_points_without_device_need_a_card(p1, entry):
    """Called without ``device``, an entry point resolves to the card and
    raises where there is none, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    space, _, K = p1
    calls = {
        "coarse_p1_solver": lambda: twolevel.coarse_p1_solver(space),
        "convection": lambda: build_upwind_convection_3d(
            HDiv3D(space.mesh, 2)),
        "build_sa_amg": lambda: amg.build_sa_amg(K, space.free_mask),
        "two_level": lambda: twolevel.two_level_preconditioner(
            space, asm.stiffness_local(space)),
        "p1_embedding": lambda: twolevel.p1_embedding(space),
        "block_jacobi": lambda: jacobi.block_jacobi(
            np.zeros((1, 1), np.int64), np.ones((1, 1, 1)), 1),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()

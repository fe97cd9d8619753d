"""The port's multi-rank execution (``navier_stokes_tpu_torch.parallel.
sharding`` and ``ddshard``, the drivers' ``group`` argument and the
sharded Reynolds ensemble) against the JAX package's, on the CPU.

The JAX functions run on the conftest's virtual CPU devices with
``device_mesh(2)``; the port runs 2 gloo ranks spawned by
``parallel.sharding.launch`` (one torch and one BLAS thread each).
Tolerances:

* ``pad_elements``, ``partition_dofs``, ``block_element_partition`` and
  ``DofPartition``'s maps: bitwise equal to JAX's;
* ``sharded_local_operator`` on tests/test_parallel.py's P2 Poisson
  problem (``unit_square_mesh(0.2)``, the JAX package's tables): within
  1e-11 of JAX's sharded apply; its CG solution within 1e-8 of JAX's
  sharded CG solution;
* ``sharded_batch_step``: bitwise equal to JAX's on u * 2 + 1, and equal
  to the unsharded map on a batch that 2 ranks split unevenly;
* the drivers' reduction: with one rank (a gloo group in this process)
  MINRES, CG and both BPCG variants give ``torch.equal`` results with
  ``group`` and without;
* the dd solve (``ddshard.sharded_flagship_solve``) on the 2D vertexstar
  model at maxh 0.3 (tests/test_parallel.py's) with the JAX package's
  Bramble-Pasciak k on 2 shards: BPCG count within 3 of JAX's sharded
  count and the velocity within 1e-6 of the port's single-device
  ``SolveInitial`` (the JAX figures, 311 iterations at k = 35.6798...,
  from ``tools/jax_faceshard_reference.py --parts dd``: the JAX sharded
  solve takes about 2 min on the CPU); a control whose inner products skip
  the ``all_reduce`` must break that bound;
* ``run_reynolds_ensemble_mcs`` with ``device_mesh`` on 2 ranks:
  ``torch.equal`` to the unsharded ensemble;
* ``build_dd_operator`` on one rank: the partitioned A and B within 1e-12
  of the model's.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.fem.spaces import H1 as JaxH1
from navier_stokes_tpu.mesh import unit_square_mesh as jax_unit_square
from navier_stokes_tpu.mesh.generators import (
    channel_with_cylinder_mesh as jax_channel,
)
from navier_stokes_tpu.ops import assembly as jasm
from navier_stokes_tpu.parallel import ddshard as jdd
from navier_stokes_tpu.parallel import sharding as jsh
from navier_stokes_tpu.solvers.cg import cg as jax_cg
from navier_stokes_tpu_torch.linalg.pytree import tdot
from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh
from navier_stokes_tpu_torch.models import NavierStokesMCS
from navier_stokes_tpu_torch.parallel import ddshard, sharding, sweep
from navier_stokes_tpu_torch.scripts.navier_stokes_2d import uin as uin2
from navier_stokes_tpu_torch.solvers import bpcg, cg, minres

SHARDS = 2
# tools/jax_faceshard_reference.py --parts dd (the JAX package on 2 CPU
# devices): BPCG iterations to 1e-9 and the Bramble-Pasciak k its Lanczos
# gives on the sharded vectors
DD_JAX = dict(iterations=311, scale_k=35.6798441458756)
DD_KW = dict(nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
             timestep=1e-3, order=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def test_padding_and_partitions_bitwise_equal_to_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((7, 3, 3))
    ed = rng.integers(0, 20, (7, 3))
    for n in (2, 3, 4):
        aj, ej = jsh.pad_elements(jnp.asarray(a), jnp.asarray(ed), n)
        ap, ep = sharding.pad_elements(torch.tensor(a), torch.tensor(ed), n)
        assert np.array_equal(ap.numpy(), np.asarray(aj))
        assert np.array_equal(ep.numpy(), np.asarray(ej))
    mesh = jax_channel(0.3)
    eldofs = mesh.elements.astype(np.int64)
    x = rng.standard_normal(mesh.nv)
    for n in (2, 3, 4):
        es = ddshard.block_element_partition(mesh.ne, n)
        assert np.array_equal(es, jdd.block_element_partition(mesh.ne, n))
        pj = jdd.partition_dofs(eldofs, mesh.nv, n, es)
        pp = ddshard.partition_dofs(eldofs, mesh.nv, n, es)
        assert (pp.n_shards, pp.ndof, pp.npad, pp.ntotal) == (
            pj.n_shards, pj.ndof, pj.npad, pj.ntotal)
        assert np.array_equal(pp.owner, pj.owner)
        assert np.array_equal(pp.slot, pj.slot)
        xs = pp.to_sharded(x)
        assert np.array_equal(xs, pj.to_sharded(x))
        assert np.array_equal(pp.to_global(xs), pj.to_global(xs))


@pytest.fixture(scope="module")
def poisson():
    mesh = jax_unit_square(0.2)
    V = JaxH1(mesh, 2, dirichlet="bottom|right|top|left")
    t = jasm.make_tables(V)
    return V, np.asarray(t.eldofs), np.asarray(jasm.stiffness_local(t))


def test_sharded_local_operator_and_cg_match_jax(poisson):
    V, eldofs, K = poisson
    A = jsh.sharded_local_operator(jnp.asarray(K), jnp.asarray(eldofs),
                                   V.ndof, jsh.device_mesh(SHARDS))
    free = jnp.asarray(V.free_mask)
    u = np.random.default_rng(0).standard_normal(V.ndof)
    y_jax = np.asarray(A(jnp.asarray(u)))

    def A_masked(v):
        return jnp.where(free, A(jnp.where(free, v, 0.0)), v)

    rhs = np.asarray(jnp.where(free, 1.0, 0.0))
    res = jax_cg(A_masked, jnp.asarray(rhs), tol=1e-10, maxsteps=500)
    y, x, its, conv = sharding.launch(
        sharding.local_operator_rank, SHARDS, torch.tensor(K),
        torch.tensor(eldofs), V.ndof, torch.tensor(u),
        torch.tensor(V.free_mask), torch.tensor(rhs), 1e-10, 500,
        device="cpu", threads=1)
    assert np.abs(y.numpy() - y_jax).max() < 1e-11
    assert conv and bool(res.converged)
    assert np.abs(x.numpy() - np.asarray(res.x)).max() < 1e-8


def test_sharded_batch_step_matches_jax():
    batch = np.random.default_rng(2).standard_normal((6, 16))
    want = np.asarray(jsh.sharded_batch_step(
        lambda u: u * 2.0 + 1.0,
        jsh.device_mesh(SHARDS))(jnp.asarray(batch)))
    ones = torch.ones(16, dtype=torch.float64)
    step = functools.partial(torch.addcmul, ones, tensor2=ones, value=2.0)
    got = sharding.launch(sharding.batch_step_rank, SHARDS, step,
                          torch.tensor(batch), device="cpu", threads=1)
    assert np.array_equal(got.numpy(), want)
    odd = torch.tensor(batch[:5])
    got = sharding.launch(sharding.batch_step_rank, SHARDS, torch.tanh, odd,
                          device="cpu", threads=1)
    assert torch.equal(got, torch.tanh(odd))


def _dense_saddle():
    rng = np.random.default_rng(4)
    n, m = 40, 12
    Q = rng.standard_normal((n, n))
    A = torch.tensor(Q @ Q.T + n * np.eye(n))
    B = torch.tensor(rng.standard_normal((m, n)))
    return A, B, torch.tensor(rng.standard_normal(n)), \
        torch.tensor(rng.standard_normal(m))


def test_drivers_reduce_over_one_rank_exactly():
    """group=None keeps the local dots; a one-rank group's all_reduce
    returns them unchanged, so every driver gives the same bits."""
    A, B, f, g = _dense_saddle()
    dA = torch.diagonal(A)
    dM = torch.diagonal(B @ torch.linalg.inv(A) @ B.T)
    ops = dict(A=lambda x: A @ x, B=lambda x: B @ x, BT=lambda p: B.T @ p,
               preA=lambda x: x / dA, preM=lambda p: p / dM)

    def runs(group):
        K = (lambda x: (A @ x[0] + B.T @ x[1], B @ x[0]))
        pre = (lambda x: (x[0] / dA, x[1] / dM))
        out = [minres.minres(K, (f, g), pre=pre, tol=1e-10, maxsteps=200,
                             group=group),
               cg.cg(ops["A"], f, pre=ops["preA"], tol=1e-12,
                     maxsteps=200, group=group),
               bpcg.bramble_pasciak_cg_opt(
                   ops["A"], ops["B"], ops["BT"], ops["preA"], ops["preM"],
                   f, g, tol=1e-10, maxsteps=300, group=group),
               bpcg.bramble_pasciak_cg(
                   ops["A"], ops["B"], ops["BT"], ops["preA"], ops["preM"],
                   f, g, tol=1e-10, max_steps=300, group=group)]
        return out, tdot((f, g), (f, g), group)

    local, d_local = runs(None)
    mesh = sharding.single_rank("gloo", device="cpu")
    try:
        reduced, d_red = runs(mesh)
    finally:
        dist.destroy_process_group()
    assert torch.equal(d_local, d_red)
    for a, b in zip(local, reduced):
        assert a.iterations == b.iterations and a.converged
        xa = a.x if isinstance(a.x, tuple) else (a.x,)
        xb = b.x if isinstance(b.x, tuple) else (b.x,)
        assert all(torch.equal(p, q) for p, q in zip(xa, xb))


@pytest.fixture(scope="module")
def dd_model():
    ns = NavierStokesMCS(channel_with_cylinder_mesh(0.3), uin=uin2,
                         preconditioner="vertexstar", device="cpu", **DD_KW)
    bundles, pu, pp = ddshard.dd_flagship_tables(ns, SHARDS)
    single = NavierStokesMCS(channel_with_cylinder_mesh(0.3), uin=uin2,
                             preconditioner="vertexstar", device="cpu",
                             **DD_KW)
    single.SolveInitial(iterative=True, GS=False, tol=1e-9, maxsteps=3000,
                        scale_k=DD_JAX["scale_k"])
    return ns, bundles, pu, single


def _dd_diff(dd_model, res, pu):
    ns, single = dd_model[0], dd_model[3]
    u = pu.to_global(res.x[0].numpy()) + ns.u_bc.numpy()
    return float(np.abs(u - single.u.numpy()).max())


def test_dd_solve_matches_jax_count_and_single_device(dd_model):
    res, pu, _ = ddshard.sharded_flagship_solve(
        dd_model[0], sharding.Ranks(SHARDS, device="cpu", threads=1),
        tol=1e-9, maxsteps=3000, scale_k=DD_JAX["scale_k"])
    diff = _dd_diff(dd_model, res, pu)
    assert res.converged
    assert abs(res.iterations - DD_JAX["iterations"]) <= 3
    assert abs(res.iterations - dd_model[3].stokes_bpcg_iterations) <= 3
    assert diff < 1e-6, diff


def test_dd_solve_control_without_reduction_breaks_the_bound(dd_model):
    """The inner products left local: each rank steps by its own half of
    every dot, and the solve no longer meets the count and solution
    bounds the test above holds (capped at 400 iterations, past the
    count the bound allows)."""
    ns, bundles, pu, _ = dd_model
    res, _ = sharding.launch(ddshard.dd_solve_rank, SHARDS, 1e-9, 400,
                             DD_JAX["scale_k"], True, device="cpu",
                             threads=1, rank_args=bundles)
    diff = _dd_diff(dd_model, res, pu)
    assert not (res.converged
                and abs(res.iterations - DD_JAX["iterations"]) <= 3
                and diff < 1e-6), (res.iterations, diff)


def test_ensemble_on_two_ranks_equals_unsharded():
    mesh = channel_with_cylinder_mesh(0.3)
    kw = dict(mesh=mesh, uin=uin2, **DD_KW)
    nus = np.geomspace(1e-3, 1e-2, 3)
    model = NavierStokesMCS(device="cpu", **kw)
    want = sweep.run_reynolds_ensemble_mcs(model, nus, 1)
    got = sharding.launch(sweep.ensemble_rank, SHARDS, NavierStokesMCS, kw,
                          nus, 1, device="cpu", threads=1)
    assert torch.equal(got, want)


def test_build_dd_operator_on_one_rank_matches_the_model(dd_model):
    """``build_dd_operator`` on a one-rank gloo group in this process: the
    partitioned A (square) and B (rectangular) applies, kernel 8 on their
    blocks as they are, equal the model's unsharded ones within 1e-12."""
    ns = dd_model[0]
    eldofs = np.asarray(ns.Xv.element_dofs)
    eldofs_p = np.asarray(ns.Q.element_dofs)
    es = ddshard.block_element_partition(ns.mesh.ne, 1)
    pu = ddshard.partition_dofs(eldofs, ns.n, 1, es)
    pp = ddshard.partition_dofs(eldofs_p, ns.Q.ndof, 1, es)
    u = np.random.default_rng(6).standard_normal(ns.n)
    mesh = sharding.single_rank("gloo", device="cpu")
    try:
        A = ddshard.build_dd_operator(ns.A_cond_np, eldofs, eldofs, pu, pu,
                                      es, mesh)
        B = ddshard.build_dd_operator(np.asarray(ns.B_loc_np), eldofs_p,
                                      eldofs, pp, pu, es, mesh)
        xs = torch.tensor(pu.to_sharded(u))
        ya, yb = A(xs).numpy(), B(xs).numpy()
    finally:
        dist.destroy_process_group()
    for got, want in ((pu.to_global(ya), ns.A_raw(torch.tensor(u))),
                      (pp.to_global(yb), ns.B_raw(torch.tensor(u)))):
        want = want.numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()

"""The face-sharded operators of ``navier_stokes_tpu_torch.parallel.
faceshard`` on 2 gloo ranks against the JAX package's sharded operators on
2 virtual CPU devices.

Both packages shard the straight 3D channel with cylinder at maxh 0.6 (the
port's model on the JAX model's host tables) with the additive skeleton
preconditioner, the JAX package's default.  The port's ranks are spawned
(``parallel.sharding.launch``, one torch and one BLAS thread each); each
applies its operators to its blocks of the same random sharded vectors,
and the gathered results are held to the JAX package's jitted sharded
operators with its own bounds (tests/test_faceshard.py): A, preA, B, B^T
within 5e-5 of the largest entry, preM within 5e-6, the f64 residual
operators within 1e-10, the equilibration D bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
from navier_stokes_tpu.parallel import faceshard as jfs
from navier_stokes_tpu.parallel.sharding import device_mesh
from navier_stokes_tpu_torch.flagship import build_model, uin
from navier_stokes_tpu_torch.models import load_host_tables
from navier_stokes_tpu_torch.parallel import faceshard as pfs
from navier_stokes_tpu_torch.parallel.sharding import launch

MAXH = 0.6
SHARDS = 2
BOUNDS = dict(A=5e-5, preA=5e-5, B=5e-5, BT=5e-5, preM=5e-6, A64=1e-10,
              B64=1e-10, BT64=1e-10)


@pytest.fixture(scope="module")
def applied():
    """Both packages' sharded operators applied to the same vectors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        cache = {}
        mj = NavierStokesMCS(
            channel_with_cylinder_mesh_3d(MAXH), nu=1e-3, inflow="inlet",
            outflow="outlet", wall="wall|cyl", uin=uin, timestep=2e-3,
            order=2, preconditioner="faceblock", assembly_cache=cache)
        mp = build_model(MAXH, device="cpu", curved=False,
                         assembly_cache=load_host_tables(
                             {f"{key}_{i}": a for key, tup in cache.items()
                              for i, a in enumerate(tup)}))
        o32, o64, D_j, plan_j, aux = jfs.build_sharded_fast_ops(
            mj, device_mesh(SHARDS))
        host = pfs.shard_fast_tables(mp, SHARDS)
    mQ = aux["mQ"]
    rng = np.random.default_rng(3)
    u = plan_j.vel_to_sharded(rng.standard_normal(mj.n))
    p = plan_j.p_to_sharded(rng.standard_normal(mj.Q.ndof), mQ)
    u32, p32 = jnp.asarray(u, jnp.float32), jnp.asarray(p, jnp.float32)
    want = {name: np.asarray(jax.jit(op)(x)) for name, op, x in (
        ("A", o32["A"], u32), ("preA", o32["preA"], u32),
        ("B", o32["B"], u32), ("BT", o32["BT"], p32),
        ("preM", o32["preM"], p32), ("A64", o64["A"], jnp.asarray(u)),
        ("B64", o64["B"], jnp.asarray(u)), ("BT64", o64["BT"],
                                            jnp.asarray(p)))}
    want["D"] = np.asarray(D_j)
    got = launch(pfs.fast_ops_rank, SHARDS, host.common, u, p,
                 device="cpu", threads=1,
                 rank_args=[host.rank(s) for s in range(SHARDS)])
    torch.set_num_threads(n)
    return want, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("name", list(BOUNDS))
def test_sharded_operator_matches_jax(applied, name):
    want, got = applied
    scale = np.abs(want[name]).max()
    err = np.abs(got[name].astype(np.float64) - want[name]).max()
    assert got[name].dtype == want[name].dtype
    assert err <= BOUNDS[name] * scale, (name, err, scale)


def test_equilibration_bitwise(applied):
    want, got = applied
    assert np.array_equal(got["D"], want["D"])

"""The face-sharded solve's host tables (``navier_stokes_tpu_torch.parallel.
faceshard.shard_fast_tables``) against the JAX package's, bitwise.

Both packages build the straight 3D channel with cylinder at maxh 0.6 (the
port's model on the JAX model's host tables).  The JAX package's
``build_sharded_fast_ops`` puts every shard's tables on its devices with
``jax.device_put(..., NamedSharding)``; the test records each such array
(and hands JAX an unsharded copy, so that no sharded executable is
compiled) and holds the port's tables to them with ``np.array_equal`` --
same shapes, dtypes and values -- at 2, 4 and 8 shards with the additive
smoother and at 2 shards with the multicolor GS sweep's per-color tables
(the coarse damping's power iteration, which runs the sharded operators,
is stubbed out on the JAX side: its tables are all this test reads).  The
plan's partition (face owners, padding, halo and produce faces, local ids)
and the layout conversions are held equal too.  No rank is spawned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from threadpoolctl import threadpool_limits

import navier_stokes_tpu.ops.faceblock as jfb
import navier_stokes_tpu.precond.multicolor as jmc
from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
from navier_stokes_tpu.parallel import faceshard as jfs
from navier_stokes_tpu.parallel.sharding import device_mesh
from navier_stokes_tpu_torch.flagship import build_model, uin
from navier_stokes_tpu_torch.models import load_host_tables
from navier_stokes_tpu_torch.parallel import faceshard as pfs

MAXH = 0.6
EXCHANGE = ("pack_slots", "pack_mask", "halo_src", "halo_mask", "rev_src",
            "rev_dst", "rev_mask", "efaces_loc", "pos2", "loc2op")
ELEMENT = ("A_hi", "A_lo", "B_hi", "B_lo", "A_64", "B_64", "ext", "inner",
           "freeF", "free_flat", "D", "dM", "M_F", "fverts", "DinvF")


@pytest.fixture(scope="module")
def models():
    """One torch thread, one BLAS thread; the JAX model and the port's on
    its host tables."""
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
        yield mj, mp, {}
    torch.set_num_threads(n)


def jax_tables(mj, n, gs, memo):
    """The arrays the JAX package's build puts on its devices, in order,
    and its plan.  The edge-star smoother (a function of the model alone)
    is built once per module."""
    rec = []
    own_put, own_dc = jax.device_put, jmc.damped_coarse
    own_sm = jfb.face_star_smoother

    def put(x, *a, **k):
        if a and isinstance(a[0], NamedSharding):
            rec.append(np.asarray(x))
            return jnp.asarray(x)
        return own_put(x, *a, **k)

    def smoother(*a, **k):
        if "sm" not in memo:
            memo["sm"] = own_sm(*a, **k)
        return memo["sm"]

    jax.device_put = put
    jmc.damped_coarse = lambda *a, **k: (None, 1.0, 1.0)
    jfb.face_star_smoother = smoother
    try:
        out = jfs.build_sharded_fast_ops(mj, device_mesh(n), gs=gs)
    finally:
        jax.device_put, jmc.damped_coarse = own_put, own_dc
        jfb.face_star_smoother = own_sm
    return rec, out[3]


def port_tables(T, gs):
    """The port's tables in the JAX package's order of device puts."""
    out = [T[k] for k in EXCHANGE + ELEMENT]
    for b in T["buckets"]:
        out += [b["inv"], b["floc"], b["mask"]]
    if gs:
        out.append(T["S"])
        for parts in T["colors"]:
            for p in parts:
                out += [p["inv"], p["floc"], p["mask"], p["P2"], p["ef2"]]
        out.append(T["ex_fv"])
    return out


@pytest.mark.parametrize("n,gs", [(2, False), (4, False), (8, False),
                                  (2, True)])
def test_shard_tables_bitwise_equal_to_jax(models, n, gs):
    mj, mp, memo = models
    with threadpool_limits(1, user_api="blas"):
        rec, jplan = jax_tables(mj, n, gs, memo)
        host = pfs.shard_fast_tables(mp, n, gs=gs)
    mine = port_tables(host.tables, gs)
    assert len(mine) == len(rec)
    for i, (a, b) in enumerate(zip(rec, mine)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape,
                                                           b.shape)
        assert np.array_equal(a, b), i
    plan = host.plan
    for attr in ("fowner", "slot_f", "elem_shard", "loc_id", "efaces_loc",
                 "pos2", "loc2op"):
        assert np.array_equal(getattr(plan, attr), getattr(jplan, attr))
    for attr in ("npad_f", "ne_max", "n_halo_max", "n_prod_pad", "Bmax",
                 "zero_row", "nloc"):
        assert getattr(plan, attr) == getattr(jplan, attr), attr
    for attr in ("own_faces", "els_of", "halo_faces", "prod_faces"):
        for a, b in zip(getattr(plan, attr), getattr(jplan, attr)):
            assert np.array_equal(a, b), attr
    # each rank's tables are its shard of the stacked ones, fresh copies
    # once on a device
    r = host.rank(n - 1)
    assert np.array_equal(r["A_hi"], host.tables["A_hi"][n - 1])
    assert np.array_equal(r["buckets"][0]["inv"],
                          host.tables["buckets"][0]["inv"][n - 1])


def test_layout_conversions_match_jax(models):
    """vel/p to and from the sharded layout, faces and elements: the same
    slots as the JAX plan's."""
    mj, mp, memo = models
    with threadpool_limits(1, user_api="blas"):
        _, jplan = jax_tables(mj, 4, False, memo)
        plan = pfs.shard_fast_tables(mp, 4).plan
    rng = np.random.default_rng(1)
    u = rng.standard_normal(mp.n)
    mQ = int(np.asarray(mp.Q.element_dofs).shape[1])
    p = rng.standard_normal(mp.Q.ndof)
    us = plan.vel_to_sharded(u)
    assert np.array_equal(us, jplan.vel_to_sharded(u))
    assert np.array_equal(plan.vel_to_global(us), u)
    ps = plan.p_to_sharded(p, mQ)
    assert np.array_equal(ps, jplan.p_to_sharded(p, mQ))
    assert np.array_equal(plan.p_to_global(ps, mQ), p)
    xF = rng.standard_normal((mp.fb.nface, 3))
    assert np.array_equal(plan.faces_to_sharded(xF),
                          jplan.faces_to_sharded(xF))
    xe = rng.standard_normal((mp.fb.ne, 2))
    assert np.array_equal(plan.elems_to_sharded(xe),
                          jplan.elems_to_sharded(xe))

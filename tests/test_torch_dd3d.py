"""The dd solve's 3D branch (``navier_stokes_tpu_torch.parallel.ddshard``:
the face+interior blocks of ``preconditioner="faceblock"``) against the
JAX package's, on the CPU.

Both packages build tests/test_parallel.py's 3D model -- the straight
channel with cylinder, order 2, nu 1e-3, dt 2e-3, the faceblock
preconditioner -- at maxh 0.6 (the port's model on the JAX model's host
tables).  The JAX package's ``ddshard.sharded_flagship_solve`` on 2
virtual devices puts every shard's tables on its devices with
``jax.device_put(..., NamedSharding)``; the test records each such array
(handing JAX an unsharded copy, and stopping the JAX call at its BPCG
solve, which no check here reads) and holds the port's
``dd_flagship_tables`` at 2 shards to them:

* the A, B, B^T and block-inverse ("pre") operator tables of every shard
  -- the element (or block) matrices and the index, halo, pack and reverse
  tables -- BITWISE (``np.array_equal``, same shapes and dtypes);
* the free mask bitwise; the right-hand sides and the pressure-mass
  diagonal within 1e-12 of the largest entry (each package's own A applies
  the boundary data, in its own summation order).

Then 2 gloo ranks (one torch and one BLAS thread each) apply the port's
sharded A, B, B^T and preA (``ddshard.dd_ops_rank``) once to random
vectors, and each result, mapped back to the global numbering, must lie
within 1e-12 of the largest entry of the model's unsharded apply (``A``,
``B``, ``BT``, ``_preA_for(False)``, each masked to the free dofs as the
dd operators are).  The solve itself runs on the
card (``chip_smoke.py`` ``[dd3d]``, maxh 0.35).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from threadpoolctl import threadpool_limits

import navier_stokes_tpu.solvers.bpcg as jbpcg
from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d as jax_mesh
from navier_stokes_tpu.models.navier_stokes_mcs import (
    NavierStokesMCS as JaxNavierStokesMCS,
)
from navier_stokes_tpu.parallel import ddshard as jdd
from navier_stokes_tpu.parallel.sharding import device_mesh
from navier_stokes_tpu_torch.flagship import uin
from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu_torch.models import NavierStokesMCS, load_host_tables
from navier_stokes_tpu_torch.parallel import ddshard, sharding

MAXH = 0.6
SHARDS = 2
KW = dict(nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
          uin=uin, timestep=2e-3, order=2, preconditioner="faceblock")
# the order of JAX's device puts per operator (build_dd_operator)
PUTS = ("mats", "edin", "edout", "halo", "hmask", "pack", "pmask", "rsrc",
        "rdst", "rmask", "rdst_rm")
OPS = ("A", "B", "BT", "pre")
BOUND = 1e-12


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def models():
    """One torch thread, one BLAS thread; the JAX model, the port's on its
    host tables, the JAX package's recorded device puts and the port's
    bundles at 2 shards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        cache = {}
        mj = JaxNavierStokesMCS(jax_mesh(MAXH), assembly_cache=cache, **KW)
        mp = NavierStokesMCS(
            channel_with_cylinder_mesh_3d(MAXH), device="cpu",
            assembly_cache=load_host_tables(
                {f"{key}_{i}": a for key, tup in cache.items()
                 for i, a in enumerate(tup)}), **KW)
        rec = jax_puts(mj)
        bundles, pu, pp = ddshard.dd_flagship_tables(mp, SHARDS)
        yield dict(mj=mj, mp=mp, rec=rec, bundles=bundles, pu=pu, pp=pp)
    torch.set_num_threads(n)


def jax_puts(mj):
    """The arrays JAX's 3D dd solve puts on its devices, in order."""
    rec = []
    own_put, own_bpcg = jax.device_put, jbpcg.bramble_pasciak_cg_opt

    def put(x, *a, **k):
        if a and isinstance(a[0], NamedSharding):
            rec.append(np.asarray(x))
            return jnp.asarray(x)
        return own_put(x, *a, **k)

    def stop(*a, **k):
        raise _Stop

    jax.device_put, jbpcg.bramble_pasciak_cg_opt = put, stop
    try:
        jdd.sharded_flagship_solve(mj, device_mesh(SHARDS), tol=1e-8)
    except _Stop:
        pass
    finally:
        jax.device_put, jbpcg.bramble_pasciak_cg_opt = own_put, own_bpcg
    assert len(rec) == len(OPS) * len(PUTS) + 4
    return rec


@pytest.mark.parametrize("op", OPS)
def test_operator_tables_bitwise_equal_to_jax(models, op):
    rec, bundles = models["rec"], models["bundles"]
    start = OPS.index(op) * len(PUTS)
    for i, name in enumerate(PUTS[:-1]):
        want = rec[start + i]
        assert want.shape[0] == SHARDS
        for s in range(SHARDS):
            got = bundles[s]["ops"][op][name]
            assert got.dtype == want.dtype, (op, name, got.dtype, want.dtype)
            assert np.array_equal(got, want[s]), (op, name, s)
    # JAX's packed (rdst, rmask) pair is the same two tables
    pair = rec[start + len(PUTS) - 1]
    for s in range(SHARDS):
        t = bundles[s]["ops"][op]
        assert np.array_equal(pair[s], np.stack([t["rdst"], t["rmask"]]))
        assert t["npad_in"] == bundles[0]["ops"][op]["npad_in"]
    if op == "pre":
        # the face+interior block inverses are square f64 tables
        m = bundles[0]["ops"]["pre"]["mats"]
        assert m.ndim == 3 and m.shape[1] == m.shape[2]
        assert m.dtype == np.float64


def test_vectors_match_jax(models):
    rec, bundles = models["rec"], models["bundles"]
    free, f, g, diag = (r.reshape(SHARDS, -1) for r in rec[-4:])
    for s in range(SHARDS):
        b = bundles[s]
        assert np.array_equal(b["free"], free[s])
        for name, want in (("f", f), ("g", g), ("diag_Mp", diag)):
            scale = np.abs(want).max()
            assert np.abs(b[name] - want[s]).max() <= BOUND * scale, name


def test_sharded_applies_match_the_model(models):
    mp, pu, pp = models["mp"], models["pu"], models["pp"]
    rng = np.random.default_rng(8)
    u = rng.standard_normal(mp.n)
    p = rng.standard_normal(mp.Q.ndof)
    got = sharding.launch(ddshard.dd_ops_rank, SHARDS, torch.tensor(
        pu.to_sharded(u)), torch.tensor(pp.to_sharded(p)), device="cpu",
        threads=1, rank_args=models["bundles"])
    ut, pt = torch.tensor(u), torch.tensor(p)
    want = dict(A=mp.A(ut), B=mp.B(ut), BT=mp.BT(pt),
                preA=mp._preA_for(False)(ut))
    for name, part in (("A", pu), ("B", pp), ("BT", pu), ("preA", pu)):
        w = want[name].numpy()
        y = part.to_global(got[name].numpy())
        assert np.abs(y - w).max() <= BOUND * np.abs(w).max(), name

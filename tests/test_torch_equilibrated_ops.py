"""``equilibrated_f32_ops``' ``split`` and ``with_ds`` keywords against the
JAX package's, on ``channel_with_cylinder_mesh_3d(0.6)``, order 2,
nu = 1e-3 (straight geometry, the port built from the JAX model's host
tables, the additive skeleton preconditioner on both sides).

* ``split=False``: A32, B32 and BT32 stream the equilibrated hi table
  alone; against the JAX package's ``split=False`` operators 1e-5 relative
  in norm, the f32 bound of the split parity (tests/test_torch_mcs3d.py);
  D equal to 1e-15 (the same numpy operations);
* ``with_ds=False`` returns the JAX package's pair ``(ops32, D)``;
* the default call (bench.py's ``split=True, with_ds=True``) returns
  operators whose applies are ``torch.equal`` to the same operators built
  from the layout's primitives, as the function built them before it took
  the keywords.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
from navier_stokes_tpu.solvers.refinement import (
    equilibrated_f32_ops as jax_equilibrated_f32_ops,
)
from navier_stokes_tpu_torch.flagship import build_model, uin
from navier_stokes_tpu_torch.models import load_host_tables
from navier_stokes_tpu_torch.models.auxspace3d import (
    build_skeleton_preconditioner_3d,
)
from navier_stokes_tpu_torch.solvers.refinement import (
    equilibrated_f32_ops,
    split_table,
)

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
    mp = build_model(MAXH, device="cpu", curved=False,
                     assembly_cache=load_host_tables(
                         {f"{key}_{i}": a for key, tup in cache.items()
                          for i, a in enumerate(tup)}))
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("NSTPU_SMOOTHER_BF16", "ext,inv")
        mpatch.setenv("NSTPU_DEVICE_TABLES", "0")
        out_j = jax_equilibrated_f32_ops(mj, gs=False, split=False)
    out_p = equilibrated_f32_ops(mp, gs=False, split=False, with_ds=False)
    rng = np.random.default_rng(4)
    u = rng.standard_normal(mp.n)
    p = rng.standard_normal(mp.Q.ndof)
    return dict(mj=mj, mp=mp, out_j=out_j, out_p=out_p, u=u, p=p)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_with_ds_false_returns_the_jax_pair(pair):
    assert len(pair["out_j"]) == 2 and len(pair["out_p"]) == 2
    (ops_p, D_p), (ops_j, D_j) = pair["out_p"], pair["out_j"]
    assert set(ops_p) == set(ops_j)
    D_j = np.asarray(D_j)
    assert np.abs(D_p.numpy() - D_j).max() <= 1e-15 * np.abs(D_j).max()


@pytest.mark.parametrize("name", ["A", "B", "BT"])
def test_split_false_matches_jax(pair, name):
    ops_p, ops_j = pair["out_p"][0], pair["out_j"][0]
    x = pair["p"] if name == "BT" else pair["u"]
    got = ops_p[name](torch.as_tensor(x, dtype=torch.float32)).numpy()
    want = np.asarray(ops_j[name](jnp.asarray(x, jnp.float32)))
    rel = _rel(got, want)
    assert rel < 1e-5, f"{name}32 split=False vs JAX: {rel:.3e}"


def test_split_false_streams_the_hi_table_alone(pair):
    ops = pair["out_p"][0]
    for name in ("A", "B", "BT"):
        assert len(ops[name].tables) == 1
        assert ops[name].tables[0].dtype == torch.float32


def test_default_call_unchanged(pair):
    mp = pair["mp"]
    lay = mp.fb
    ops32, D, ops_ds = equilibrated_f32_ops(mp, gs=False)
    # the same operators from the layout's primitives
    eldofs = np.asarray(mp.Xv.element_dofs)
    De = D.numpy()[eldofs]
    A_s = mp.A_cond_np * De[:, :, None] * De[:, None, :]
    shared = lay.pack_elem_tables(split_table(lay.permute_blocks(A_s)))
    B_sp = (mp.B_loc_np * De[:, None, :])[:, :, lay.perm]
    B_shared = lay.pack_elem_tables(split_table(B_sp))
    B32, BT32 = lay.rect_apply_multi(B_shared, mp.Q.element_dofs)
    B_ds, BT_ds = lay.rect_apply_comp(*B_shared, mp.Q.element_dofs)
    preA = build_skeleton_preconditioner_3d(
        mp.Xv, A_s, mp._dirich, "cpu", torch.float32,
        coarse_coefficient=mp.nu, dof_scale=D.numpy(), gs=False)
    free = mp.free
    u32 = torch.as_tensor(pair["u"], dtype=torch.float32)
    p32 = torch.as_tensor(pair["p"], dtype=torch.float32)
    u64, p64 = (torch.as_tensor(pair[k]) for k in ("u", "p"))
    uf32, uf64 = (torch.where(free, v, 0.0) for v in (u32, u64))
    cases = [
        (ops32["A"](u32),
         torch.where(free, lay.elem_apply_tiled(shared)(uf32), u32)),
        (ops32["B"](u32), B32(uf32)),
        (ops32["BT"](p32), torch.where(free, BT32(p32), 0.0)),
        (ops32["preA"](u32), preA(u32)),
        (ops_ds["A"](u64),
         torch.where(free, lay.elem_apply_comp(*shared)(uf64), u64)),
        (ops_ds["B"](u64), B_ds(uf64)),
        (ops_ds["BT"](p64), torch.where(free, BT_ds(p64), 0.0)),
    ]
    for got, want in cases:
        assert torch.equal(got, want)


def test_split_k_needs_split(pair):
    with pytest.raises(ValueError):
        equilibrated_f32_ops(pair["mp"], split=False, split_k=2)

"""Parity of the port's table-stream matvec variants (``ops/stream_mv.py``)
with the kernels of the JAX package's two microbenchmark scripts.

The scripts themselves cannot be imported here (they pick a platform and
read ``sys.argv`` at import, and their ``pallas_call`` has no interpret
switch), so the JAX side of each variant is its kernel body --
``pack_tiles`` and ``_bmv`` of ``ops/pallas_mv.py`` applied tile by tile --
with the variant's own grouping of tiles, written out as the script does it:

* ``make_bmv`` (one tile per grid step) against ``block_mv_rows``;
* ``make_bmv_splitk_seq`` (k consecutive-tile operands, outputs interleaved
  back) against the port's ``make_bmv_splitk_seq``;
* ``make_bmv_mega`` (k tiles as one block) against ``block_mv_mega``;
* ``make_bmv_manual`` (a loop over all tiles) against ``block_mv_ring``;
* ``mv_kernel``'s body against ``block_mv_soa``, and the whole face apply
  around it against the JAX ``FaceBlockLayout``'s at maxh = 0.6.

On the CPU every wrapper takes its plain version; float32, rtol 1e-5 of
sum_j |a_ij x_j| (f32 sums in another order).  The comparison of each CUDA
kernel with its plain version on the card is in ``tests/test_torch_cuda.py``
(``cuda`` marker, no JAX import).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.fem.hdiv3d import HDiv3D as JaxHDiv3D
from navier_stokes_tpu.mesh import (
    channel_with_cylinder_mesh_3d as jax_mesh_3d,
)
from navier_stokes_tpu.models.stokes_hybrid3d import (
    HybridVelocitySpace3D as JaxHybrid,
)
from navier_stokes_tpu.models.stokes_hybrid3d import (
    VectorFacet3D as JaxVectorFacet3D,
)
from navier_stokes_tpu.ops.faceblock import FaceBlockLayout as JaxLayout
from navier_stokes_tpu.ops.pallas_mv import _bmv, pack_tiles
from navier_stokes_tpu_torch.fem.hdiv3d import HDiv3D
from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu_torch.models.stokes_hybrid3d import (
    HybridVelocitySpace3D,
    VectorFacet3D,
)
from navier_stokes_tpu_torch.ops import block_mv as bm
from navier_stokes_tpu_torch.ops import stream_mv as sm
from navier_stokes_tpu_torch.ops.faceblock import FaceBlockLayout
from navier_stokes_tpu_torch.scripts import microbench_apply2, microbench_dma

RTOL = 1e-5
# (nblk, m, k): the bench block, a block count that is no multiple of the
# tile or of k, and a non-square table
SHAPES = [(64, 54, 54), (37, 54, 54), (53, 6, 14)]
# block_mv_rows also on odd k: 259 rows of 13 entries, so that a stretch of
# 1, 432 or 864 rows ends off a 16-byte boundary
ROWS_SHAPES = SHAPES + [(37, 7, 13)]
TILE = 8


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


def _data(nblk, m, k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nblk, m, k)).astype(np.float32),
            rng.standard_normal((nblk, k)).astype(np.float32))


def _jax_tiles(A, x, tile, k=1):
    """The packed table (ntile, m, nb, tile), the tile count padded to a
    multiple of k (the scripts drop the odd tiles instead; padding keeps
    every block), and x as the scripts pass it: (nb, ntile*tile)."""
    At = pack_tiles(A, tile)
    ntile = -(-At.shape[0] // k) * k
    At = np.concatenate(
        [At, np.zeros((ntile - At.shape[0],) + At.shape[1:], np.float32)])
    xs = np.zeros((A.shape[2], ntile * tile), np.float32)
    xs[:, :A.shape[0]] = x.T
    return jnp.asarray(At), jnp.asarray(xs)


def _jax_bmv(A, x, tile):
    """``make_bmv``: grid step i takes tile i and columns i of x."""
    At, xs = _jax_tiles(A, x, tile)
    nt = At.shape[0]
    y = jnp.concatenate([_bmv(At[i], xs[:, i * tile:(i + 1) * tile])
                         for i in range(nt)], axis=1)
    return np.asarray(y)[:, :A.shape[0]].T


def _jax_splitk_seq(A, x, tile, k):
    """``make_bmv_splitk_seq``: sub j holds global tiles i*k+j; x enters
    grouped (ng, k, nb, tile); the k outputs are interleaved back."""
    At, xs = _jax_tiles(A, x, tile, k)
    ntile, m, nb, _ = At.shape
    ng = ntile // k
    grp = At.reshape(ng, k, m, nb, tile)
    subs = [grp[:, j] for j in range(k)]
    xg = xs.reshape(nb, ng, k, tile).transpose(1, 2, 0, 3)
    outs = [jnp.stack([_bmv(subs[j][i], xg[i, j]) for i in range(ng)])
            for j in range(k)]
    y = jnp.stack(outs, axis=1)  # (ng, k, m, tile)
    y = y.transpose(2, 0, 1, 3).reshape(m, ntile * tile)
    return np.asarray(y)[:, :A.shape[0]].T


def _jax_mega(A, x, tile, k):
    """``make_bmv_mega``: grid step i takes the (k*m, nb, tile) block."""
    At, xs = _jax_tiles(A, x, tile, k)
    ntile, m, nb, _ = At.shape
    ng = ntile // k
    mega = At.reshape(ng, k * m, nb, tile)
    xg = xs.reshape(nb, ng, k, tile).transpose(1, 2, 0, 3)
    steps = []
    for i in range(ng):
        a = mega[i].reshape(k, m, nb, tile)
        steps.append(jnp.stack([_bmv(a[j], xg[i, j]) for j in range(k)]))
    y = jnp.stack(steps)  # (ng, k, m, tile)
    y = y.transpose(2, 0, 1, 3).reshape(m, ntile * tile)
    return np.asarray(y)[:, :A.shape[0]].T


def _jax_manual(A, x, tile):
    """``make_bmv_manual``: one loop over all tiles, x as (ntile, nb, t)."""
    At, xs = _jax_tiles(A, x, tile)
    ntile, m, nb, _ = At.shape
    xg = xs.reshape(nb, ntile, tile).transpose(1, 0, 2)
    y = jnp.stack([_bmv(At[i], xg[i]) for i in range(ntile)])
    y = y.transpose(1, 0, 2).reshape(m, ntile * tile)
    return np.asarray(y)[:, :A.shape[0]].T


def _close(got, want, A, x):
    scale = np.einsum("bmk,bk->bm", np.abs(A).astype(np.float64),
                      np.abs(x).astype(np.float64))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err / scale).max() <= RTOL


@pytest.mark.parametrize("rows", [0, 1, 5, 64, 432, 864])
@pytest.mark.parametrize("shape", ROWS_SHAPES)
def test_block_mv_rows_matches_jax_tiles(shape, rows):
    A, x = _data(*shape)
    got = sm.block_mv_rows(torch.from_numpy(A), torch.from_numpy(x), rows)
    _close(got, _jax_bmv(A, x, TILE), A, x)


@pytest.mark.parametrize("rows", microbench_dma.ROWS)
def test_rows_smem_bytes_fit_at_the_microbenchmark_sizes(rows):
    """The kernel's layout at k = m = 54 -- the header of one mbarrier per
    warp and one for x, the tile with its shift, the x blocks with theirs
    -- fits the 227 KB a CTA may opt in to, 864 rows included, and the
    wrapper refuses the first row count past it."""
    warps = min(-(-rows // 32), 32)
    want = (-(-8 * (warps + 1) // 16) * 16
            + 4 * ((rows * 54 + 6) // 4 * 4)
            + 4 * (((rows - 1) // 54 + 2) * 54 + 3))
    assert sm.rows_smem_bytes(rows, 54, 54) == want <= sm.SMEM_OPT_IN
    assert sm.rows_smem_bytes(864, 54, 54) == 190548
    most = max(r for r in range(864, 1200)
               if sm.rows_smem_bytes(r, 54, 54) <= sm.SMEM_OPT_IN)
    A, x = torch.zeros((40, 54, 54)), torch.zeros((40, 54))
    assert sm.block_mv_rows(A, x, most).shape == (40, 54)
    with pytest.raises(ValueError):
        sm.block_mv_rows(A, x, most + 1)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_splitk_seq_matches_jax_grouping(shape, k):
    A, x = _data(*shape)
    apply = sm.make_bmv_splitk_seq(torch.from_numpy(A), k, TILE)
    assert len(apply.table) == k
    _close(apply(torch.from_numpy(x)), _jax_splitk_seq(A, x, TILE, k), A, x)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_block_mv_mega_matches_jax_megablock(shape, k):
    A, x = _data(*shape)
    got = sm.block_mv_mega(torch.from_numpy(A), torch.from_numpy(x), k, 4)
    _close(got, _jax_mega(A, x, TILE, k), A, x)


@pytest.mark.parametrize("nbuf", [2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_block_mv_ring_matches_jax_manual_pipeline(shape, nbuf):
    A, x = _data(*shape)
    got = sm.block_mv_ring(torch.from_numpy(A), torch.from_numpy(x), nbuf, 4)
    _close(got, _jax_manual(A, x, TILE), A, x)


@pytest.mark.parametrize("nb,ne,ne_p", [(54, 40, 64), (7, 33, 33)])
def test_block_mv_soa_matches_jax_kernel_body(nb, ne, ne_p):
    rng = np.random.default_rng(3)
    A2 = np.zeros((nb, nb, ne_p), np.float32)
    uT = np.zeros((nb, ne_p), np.float32)
    A2[:, :, :ne] = rng.standard_normal((nb, nb, ne))
    uT[:, :ne] = rng.standard_normal((nb, ne))
    # the kernel body's one line (scripts/microbench_apply2.py:126)
    want = np.asarray(jnp.sum(jnp.asarray(A2) * jnp.asarray(uT)[None], axis=1))
    for fn in (sm.block_mv_soa, sm.block_mv_soa_plain):
        got = fn(torch.from_numpy(A2), torch.from_numpy(uT))
        assert got.dtype == torch.float32 and got.shape == (nb, ne_p)
        scale = np.einsum("ije,je->ie", np.abs(A2).astype(np.float64),
                          np.abs(uT).astype(np.float64))
        err = np.abs(got.numpy().astype(np.float64) - want)
        assert (err / np.maximum(scale, 1e-300)).max() <= RTOL
        assert float(got[:, ne:].abs().max() if ne_p > ne else 0.0) == 0.0


def test_block_mv_soa_takes_any_element_count_on_the_cpu():
    """The card's kernel refuses an element count that is no multiple of 4
    (its tensor maps need 16-byte strides); a CPU table of any count still
    goes to the plain version, here against the JAX kernel body."""
    rng = np.random.default_rng(5)
    A2 = rng.standard_normal((7, 7, 333)).astype(np.float32)
    uT = rng.standard_normal((7, 333)).astype(np.float32)
    want = np.asarray(jnp.sum(jnp.asarray(A2) * jnp.asarray(uT)[None], axis=1))
    flat = torch.zeros(1 + A2.size)
    flat[1:] = torch.from_numpy(A2.ravel())
    A2t = flat[1:].view(7, 7, 333)  # 4 bytes past the allocation's start
    got = sm.block_mv_soa(A2t, torch.from_numpy(uT))
    assert torch.equal(got, sm.block_mv_soa_plain(A2t, torch.from_numpy(uT)))
    scale = np.einsum("ije,je->ie", np.abs(A2).astype(np.float64),
                      np.abs(uT).astype(np.float64))
    assert (np.abs(got.numpy() - want) / scale).max() <= RTOL


def test_face_apply_soa_matches_jax_face_apply():
    """The face apply around the SoA product against the JAX layout's
    split -> gather -> einsum -> scatter -> join on the same table."""
    maxh = 0.6
    jmesh = jax_mesh_3d(maxh)
    jlay = JaxLayout(JaxHybrid(JaxHDiv3D(jmesh, 2),
                               JaxVectorFacet3D(jmesh, 1)))
    mesh = channel_with_cylinder_mesh_3d(maxh)
    Xv = HybridVelocitySpace3D(HDiv3D(mesh, 2), VectorFacet3D(mesh, 1))
    lay = FaceBlockLayout(Xv, "cpu")
    ne, nb, n = mesh.ne, lay.nb, Xv.ndof
    assert (jmesh.ne, jlay.nb) == (ne, nb)
    rng = np.random.default_rng(0)
    A_np = rng.standard_normal((ne, nb, nb)).astype(np.float32)
    u = rng.standard_normal(n).astype(np.float32)

    A_j = jnp.asarray(jlay.permute_blocks(A_np))
    uF, ui = jlay.split(jnp.asarray(u))
    ye = jnp.einsum("eij,ej->ei", A_j, jlay.gather_elem(uF, ui))
    want = np.asarray(jlay.join(*jlay.scatter_elem(ye)), np.float64)

    A2 = sm.pack_soa(lay.permute_blocks(A_np), 256)
    assert A2.shape == (nb, nb, -(-ne // 256) * 256)
    for mv in (sm.block_mv_soa, sm.block_mv_soa_plain):
        got = sm.face_apply_soa(lay, A2, mv)(torch.from_numpy(u))
        assert got.dtype == torch.float32 and got.shape == (n,)
        d = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert d <= RTOL


def test_microbench_scripts_run_on_the_cpu():
    """Both ported scripts at a small size: every variant present, checked
    against the plain version, and no time taken without a card."""
    rows = microbench_dma.main(37, 14, device="cpu")
    kernels = {r["kernel"] for r in rows}
    assert kernels == {"library", "block_mv", "block_mv_rows",
                       "block_mv_splitk", "block_mv_mega", "block_mv_ring"}
    assert len(rows) == 3 + 4 + 6 + 4 + 6
    assert all(r["ms"] is None and r["max_abs_err"] <= 1e-4 for r in rows)
    rows = microbench_apply2.main(0.6, device="cpu")
    assert [r["label"] for r in rows] == [
        "SoA einsum only:", "SoA kernel only:", "face apply (SoA einsum):",
        "face apply (SoA kernel):", "face apply (AoS block_mv):"]
    assert all(r["ms"] is None for r in rows)
    assert all(rows[i]["dev"] <= 1e-5 for i in (1, 3, 4))


@pytest.mark.parametrize("case", [
    "rows_negative", "rows_too_many", "mega_unaligned", "mega_too_large",
    "ring_nbuf", "ring_unaligned", "f64", "x_shape", "soa_shape",
    "soa_dtype", "soa_contiguous"])
def test_stream_mv_rejects_bad_inputs(case):
    A = torch.zeros((10, 6, 6))
    x = torch.zeros((10, 6))
    A2, uT = torch.zeros((5, 5, 8)), torch.zeros((5, 8))
    with pytest.raises((TypeError, ValueError)):
        if case == "rows_negative":
            sm.block_mv_rows(A, x, -1)
        elif case == "rows_too_many":
            sm.block_mv_rows(A, x, 10**5)
        elif case == "mega_unaligned":
            sm.block_mv_mega(A, x, 1, 3)  # 18 floats: not 16-byte units
        elif case == "mega_too_large":
            sm.block_mv_mega(A, x, 4, 10**4)
        elif case == "ring_nbuf":
            sm.block_mv_ring(A, x, 9, 4)
        elif case == "ring_unaligned":
            sm.block_mv_ring(A, x, 2, 3)
        elif case == "f64":
            sm.block_mv_rows(A.double(), x.double())
        elif case == "x_shape":
            sm.block_mv_ring(A, torch.zeros((10, 5)), 2, 4)
        elif case == "soa_shape":
            sm.block_mv_soa(A2, torch.zeros((5, 7)))
        elif case == "soa_dtype":
            sm.block_mv_soa(A2.double(), uT.double())
        else:
            sm.block_mv_soa(A2.transpose(0, 1)[:, :, ::2], uT[:, ::2])

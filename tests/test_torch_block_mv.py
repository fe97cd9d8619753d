"""Parity of the port's block-matvec module (navier_stokes_tpu_torch/ops/
block_mv.py) with the JAX package's Pallas kernels (ops/pallas_mv.py).

On the CPU each wrapper takes its plain PyTorch version; the JAX kernels run
in interpret mode, as tests/test_pallas_mv.py runs them.  Inputs are made
with numpy from a seed and handed to both.  Tolerances:

* block_mv / block_mv2 / make_table_apply: |d| <= 1e-5 * sum_j |a_ij x_j|
  (f32 arithmetic, sums taken in another order);
* block_mv_comp: y_hi + y_lo within 1e-12 of sum_j |a_ij x_j| of the f64
  product, as the Pallas kernel is held (test_pallas_mv.py:125-151);
* the segment apply (the GS solve tables without padding): its plain
  version within 1e-6 (f32 arithmetic) or 1e-14 (f64) of sum_j |a_ij x_j|
  of ``block_mv_plain`` on the padded table, the pad entries exactly 0;
* the split-k versions: the same bounds against the JAX split-k launchers,
  fed through ``_pack_splitk`` (tests/test_pallas_mv.py:196-240), also at
  the edges of the kernels' CTA stretches (``EDGE_SPLITK``); the
  port's sub-tables EQUAL the JAX sub-tables up to layout; the compensated
  split-k version BITWISE equal to the unsplit one on the cancellation
  case, and the face-block applies at split_k=2 equal to split_k=1.

The kernels themselves run only on the card: their tests are in
``tests/test_torch_cuda.py`` (``cuda`` marker, no JAX import).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu.ops.pallas_mv import make_table_apply as jax_table_apply
from navier_stokes_tpu.ops.pallas_mv import (
    _call_mv2_splitk,
    _call_mv_comp_splitk,
    _call_mv_splitk,
    _pack_splitk,
    pack_tiles,
    tiled_bmv,
    tiled_bmv_comp,
    tiled_bmv_multi,
)
from navier_stokes_tpu_torch.ops import block_mv as bm
from navier_stokes_tpu_torch.ops import stream_mv
from navier_stokes_tpu_torch.ops.local_mv import batched_local_matvec

NE, NB, TILE = 37, 14, 16  # deliberately non-multiple ne, as test_pallas_mv
STILE = 8  # split-k tile: 5 tiles, which neither k = 2 nor k = 3 divides
# The edges of the split-k kernels' CTA stretches (kernels 5-7; the same
# shapes as chip_smoke.EDGE_SPLITK), (nblk, m, k, tile): stretches that
# cross a tile boundary (tile * m not a multiple of the rows per
# stretch), rows * k not a multiple of 4 floats or of 8 bf16 entries
# (ragged tails of up to 7 entries after the last whole 16-byte unit), real
# rows that end mid-stretch, and at k = 8 sub-tables of zero pad only.
EDGE_SPLITK = [(37, 6, 7, 8), (300, 54, 54, 8), (301, 4, 54, 16),
               (45, 54, 4, 3), (5, 3, 7, 2), (19, 5, 3, 4), (203, 7, 9, 16)]


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


def _pad_soa(x):
    """(NE, k) AoS -> (k, ntile*TILE) zero-padded SoA for the JAX kernels."""
    ntile = -(-NE // TILE)
    out = np.zeros((x.shape[1], ntile * TILE), np.float32)
    out[:, :NE] = x.T
    return jnp.asarray(out)


def _row_scale(A, x):
    return np.einsum("emk,ek->em", np.abs(A.astype(np.float64)),
                     np.abs(x.astype(np.float64)))


def _assert_within(got, want, scale, tol):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    worst = float((err / np.maximum(scale, 1e-300)).max())
    assert worst <= tol, worst


@pytest.mark.parametrize("m,k", [(NB, NB), (6, NB), (NB, 9)])
def test_block_mv_matches_pallas(m, k):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((NE, m, k)).astype(np.float32)
    x = rng.standard_normal((NE, k)).astype(np.float32)
    want = np.asarray(tiled_bmv(jnp.asarray(pack_tiles(A, TILE)), _pad_soa(x),
                                interpret=True))[:, :NE].T
    got = bm.block_mv(torch.from_numpy(A), torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (NE, m)
    _assert_within(got, want, _row_scale(A, x), 1e-5)


@pytest.mark.parametrize("m,k", [(NB, NB), (6, NB), (NB, 9)])
def test_make_table_apply_bf16_matches_pallas(m, k):
    """bf16-stored tables with f32 arithmetic: the same rounded table on
    both sides, so only the summation order differs."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((NE, m, k)).astype(np.float32)
    x = rng.standard_normal((NE, k)).astype(np.float32)
    f_jax = jax_table_apply(A, tile=TILE, interpret=True, min_pallas_blocks=1,
                            store_dtype=jnp.bfloat16)
    want = np.asarray(f_jax(jnp.asarray(x)))
    f_port = bm.make_table_apply(A, store_dtype=torch.bfloat16, device="cpu")
    assert f_port.table.dtype == torch.bfloat16
    got = f_port(torch.from_numpy(x)).numpy()
    A_bf = f_port.table.to(torch.float32).numpy()
    _assert_within(got, want, _row_scale(A_bf, x), 1e-5)
    # and the f32-stored apply against the f32 Pallas path
    want32 = np.asarray(jax_table_apply(A, tile=TILE, interpret=True,
                                        min_pallas_blocks=1)(jnp.asarray(x)))
    got32 = bm.make_table_apply(A, device="cpu")(torch.from_numpy(x)).numpy()
    _assert_within(got32, want32, _row_scale(A, x), 1e-5)


def test_block_mv2_matches_pallas():
    A64 = np.random.default_rng(3).standard_normal((NE, NB, NB))
    A_hi = A64.astype(np.float32)
    A_lo = (A64 - A_hi.astype(np.float64)).astype(np.float32)
    x = np.random.default_rng(4).standard_normal((NE, NB)).astype(np.float32)
    want = np.asarray(tiled_bmv_multi(
        jnp.asarray(pack_tiles(A_hi, TILE)), jnp.asarray(pack_tiles(A_lo, TILE)),
        _pad_soa(x), interpret=True))[:, :NE].T
    got = bm.block_mv2(torch.from_numpy(A_hi), torch.from_numpy(A_lo),
                       torch.from_numpy(x)).numpy()
    _assert_within(got, want, _row_scale(A64, x), 1e-5)


def _cancellation_case(seed=11):
    """~1e5 row cancellation (test_pallas_mv.py:125-151)."""
    rng = np.random.default_rng(seed)
    A64 = rng.standard_normal((NE, NB, NB))
    x64 = rng.standard_normal((NE, NB))
    A64[:, :, 0] *= 1e5
    A64[:, :, 1] = -A64[:, :, 0] * (x64[:, 0] / x64[:, 1])[:, None]
    return A64, x64


def test_block_mv_comp_cancellation_matches_pallas():
    A64, x64 = _cancellation_case()
    want = np.einsum("eij,ej->ei", A64, x64)
    scale = _row_scale(A64, x64)
    A_hi = A64.astype(np.float32)
    A_lo = (A64 - A_hi.astype(np.float64)).astype(np.float32)
    x_hi, x_lo = bm.split_f64(torch.from_numpy(x64))
    yh, yl = bm.block_mv_comp(torch.from_numpy(A_hi), torch.from_numpy(A_lo),
                              x_hi, x_lo)
    got = yh.double().numpy() + yl.double().numpy()
    _assert_within(got, want, scale, 1e-12)
    jh, jl = tiled_bmv_comp(
        jnp.asarray(pack_tiles(A_hi, TILE)), jnp.asarray(pack_tiles(A_lo, TILE)),
        _pad_soa(x_hi.numpy()), _pad_soa(x_lo.numpy()), interpret=True)
    jax_got = (np.asarray(jh, np.float64) + np.asarray(jl, np.float64))[:, :NE].T
    _assert_within(got, jax_got, scale, 1e-12)
    # the plain three-product f32 split is far worse on the same data
    ah, al = torch.from_numpy(A_hi), torch.from_numpy(A_lo)
    plain = sum(bm.block_mv_plain(a, x).double()
                for a, x in ((ah, x_hi), (ah, x_lo), (al, x_hi))).numpy()
    err_plain = float((np.abs(plain - want) / scale).max())
    assert err_plain > 1e3 * float((np.abs(got - want) / scale).max())


def _jax_splitk(A, k, tile=STILE):
    """The JAX split-k operands of a table: _pack_splitk of pack_tiles."""
    subs, ng = _pack_splitk(pack_tiles(A, tile), k)
    return subs, ng * k * tile


def _soa(x, npad):
    out = np.zeros((x.shape[1], npad), x.dtype)
    out[:, :x.shape[0]] = x.T
    return jnp.asarray(out)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_block_mv_splitk_matches_pallas(k, dtype):
    rng = np.random.default_rng(20 + k)
    A = rng.standard_normal((NE, 6, NB)).astype(np.float32)
    x = rng.standard_normal((NE, NB)).astype(np.float32)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    subs = bm.pack_splitk(torch.from_numpy(A).to(tdt), k, STILE)
    A_r = torch.from_numpy(A).to(tdt).to(torch.float32).numpy()  # as stored
    jsubs, npad = _jax_splitk(A_r, k)
    for sp, sj in zip(subs, jsubs):  # the same sub-tables, natural layout
        np.testing.assert_array_equal(
            sp.to(torch.float32).numpy(),
            sj.transpose(0, 3, 1, 2).reshape(sp.shape))
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    want = np.asarray(_call_mv_splitk(
        k, _soa(x, npad), *[jnp.asarray(a).astype(jdt) for a in jsubs],
        interpret=True))[:, :NE].T
    got = bm.block_mv_splitk(subs, torch.from_numpy(x), STILE).numpy()
    assert got.dtype == np.float32 and got.shape == (NE, 6)
    _assert_within(got, want, _row_scale(A_r, x), 1e-5)
    # the plain split-k version against the unsplit one on the same table
    unsplit = bm.block_mv(torch.from_numpy(A).to(tdt), torch.from_numpy(x))
    _assert_within(got, unsplit.numpy(), _row_scale(A_r, x), 1e-6)


@pytest.mark.parametrize("k", [2, 3])
def test_block_mv2_splitk_matches_pallas(k):
    A64 = np.random.default_rng(30 + k).standard_normal((NE, NB, NB))
    A_hi = A64.astype(np.float32)
    A_lo = (A64 - A_hi.astype(np.float64)).astype(np.float32)
    x = np.random.default_rng(4).standard_normal((NE, NB)).astype(np.float32)
    hs, npad = _jax_splitk(A_hi, k)
    ls, _ = _jax_splitk(A_lo, k)
    want = np.asarray(_call_mv2_splitk(
        k, _soa(x, npad), *[jnp.asarray(a) for a in hs + ls],
        interpret=True))[:, :NE].T
    got = bm.block_mv2_splitk(bm.pack_splitk(torch.from_numpy(A_hi), k, STILE),
                              bm.pack_splitk(torch.from_numpy(A_lo), k, STILE),
                              torch.from_numpy(x), STILE).numpy()
    _assert_within(got, want, _row_scale(A64, x), 1e-5)


@pytest.mark.parametrize("k", [2, 3])
def test_block_mv_comp_splitk_matches_pallas_and_unsplit(k):
    A64, x64 = _cancellation_case(40 + k)
    want = np.einsum("eij,ej->ei", A64, x64)
    scale = _row_scale(A64, x64)
    A_hi = A64.astype(np.float32)
    A_lo = (A64 - A_hi.astype(np.float64)).astype(np.float32)
    x_hi, x_lo = bm.split_f64(torch.from_numpy(x64))
    ah, al = torch.from_numpy(A_hi), torch.from_numpy(A_lo)
    yh, yl = bm.block_mv_comp_splitk(bm.pack_splitk(ah, k, STILE),
                                     bm.pack_splitk(al, k, STILE),
                                     x_hi, x_lo, STILE)
    got = yh.double().numpy() + yl.double().numpy()
    _assert_within(got, want, scale, 1e-12)
    hs, npad = _jax_splitk(A_hi, k)
    ls, _ = _jax_splitk(A_lo, k)
    jh, jl = _call_mv_comp_splitk(
        k, _soa(x_hi.numpy(), npad), _soa(x_lo.numpy(), npad),
        *[jnp.asarray(a) for a in hs + ls], interpret=True)
    jax_got = (np.asarray(jh, np.float64)
               + np.asarray(jl, np.float64))[:, :NE].T
    _assert_within(got, jax_got, scale, 1e-12)
    rh, rl = bm.block_mv_comp(ah, al, x_hi, x_lo)
    assert torch.equal(yh, rh) and torch.equal(yl, rl)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("nblk,m,kk,tile", EDGE_SPLITK)
def test_block_mv_comp_splitk_edges_match_pallas(nblk, m, kk, tile, k):
    """Kernel 7 at the edges of its CTA stretches: the JAX split-k launcher
    in interpret mode against the port (its plain version on the CPU), both
    within 1e-12 of the row scale of the f64 product, and the port BITWISE
    equal to the unsplit block_mv_comp."""
    rng = np.random.default_rng(70 + k)
    A64 = rng.standard_normal((nblk, m, kk))
    x64 = rng.standard_normal((nblk, kk))
    want = np.einsum("eij,ej->ei", A64, x64)
    scale = _row_scale(A64, x64)
    A_hi = A64.astype(np.float32)
    A_lo = (A64 - A_hi.astype(np.float64)).astype(np.float32)
    x_hi, x_lo = bm.split_f64(torch.from_numpy(x64))
    ah, al = torch.from_numpy(A_hi), torch.from_numpy(A_lo)
    yh, yl = bm.block_mv_comp_splitk(bm.pack_splitk(ah, k, tile),
                                     bm.pack_splitk(al, k, tile),
                                     x_hi, x_lo, tile)
    assert yh.shape == yl.shape == (nblk, m)
    got = yh.double().numpy() + yl.double().numpy()
    _assert_within(got, want, scale, 1e-12)
    hs, npad = _jax_splitk(A_hi, k, tile)
    ls, _ = _jax_splitk(A_lo, k, tile)
    jh, jl = _call_mv_comp_splitk(
        k, _soa(x_hi.numpy(), npad), _soa(x_lo.numpy(), npad),
        *[jnp.asarray(a) for a in hs + ls], interpret=True)
    jax_got = (np.asarray(jh, np.float64)
               + np.asarray(jl, np.float64))[:, :nblk].T
    _assert_within(got, jax_got, scale, 1e-12)
    rh, rl = bm.block_mv_comp(ah, al, x_hi, x_lo)
    assert torch.equal(yh, rh) and torch.equal(yl, rl)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("nblk,m,kk,tile", EDGE_SPLITK)
def test_block_mv_splitk_edges_match_pallas(nblk, m, kk, tile, k, dtype):
    """Kernel 5 at the edges of its CTA stretches: the JAX split-k launcher
    in interpret mode against the port (its plain version on the CPU) on
    the same stored table, within 1e-5 of sum_j |a_ij x_j| (f32
    arithmetic, sums in another order), and the port within 1e-6 of the
    unsplit block_mv (on the card the two are bitwise equal)."""
    rng = np.random.default_rng(80 + k)
    A = rng.standard_normal((nblk, m, kk)).astype(np.float32)
    x = rng.standard_normal((nblk, kk)).astype(np.float32)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    At = torch.from_numpy(A).to(tdt)
    A_r = At.to(torch.float32).numpy()  # as stored
    got = bm.block_mv_splitk(bm.pack_splitk(At, k, tile), torch.from_numpy(x),
                             tile).numpy()
    assert got.dtype == np.float32 and got.shape == (nblk, m)
    jsubs, npad = _jax_splitk(A_r, k, tile)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    want = np.asarray(_call_mv_splitk(
        k, _soa(x, npad), *[jnp.asarray(a).astype(jdt) for a in jsubs],
        interpret=True))[:, :nblk].T
    scale = _row_scale(A_r, x)
    _assert_within(got, want, scale, 1e-5)
    _assert_within(got, bm.block_mv(At, torch.from_numpy(x)).numpy(), scale,
                   1e-6)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("nblk,m,kk,tile", EDGE_SPLITK)
def test_block_mv2_splitk_edges_match_pallas(nblk, m, kk, tile, k):
    """Kernel 6 at the edges of its CTA stretches: the JAX split-k launcher
    in interpret mode against the port, within 1e-5 of sum_j |a_ij x_j|
    of the f64 table, and the port within 1e-6 of the unsplit block_mv2."""
    rng = np.random.default_rng(90 + k)
    A64 = rng.standard_normal((nblk, m, kk))
    A_hi = A64.astype(np.float32)
    A_lo = (A64 - A_hi.astype(np.float64)).astype(np.float32)
    x = rng.standard_normal((nblk, kk)).astype(np.float32)
    ah, al = torch.from_numpy(A_hi), torch.from_numpy(A_lo)
    got = bm.block_mv2_splitk(bm.pack_splitk(ah, k, tile),
                              bm.pack_splitk(al, k, tile),
                              torch.from_numpy(x), tile).numpy()
    assert got.dtype == np.float32 and got.shape == (nblk, m)
    hs, npad = _jax_splitk(A_hi, k, tile)
    ls, _ = _jax_splitk(A_lo, k, tile)
    want = np.asarray(_call_mv2_splitk(
        k, _soa(x, npad), *[jnp.asarray(a) for a in hs + ls],
        interpret=True))[:, :nblk].T
    scale = _row_scale(A64, x)
    _assert_within(got, want, scale, 1e-5)
    _assert_within(got, bm.block_mv2(ah, al, torch.from_numpy(x)).numpy(),
                   scale, 1e-6)


def test_make_table_apply_splitk_equals_unsplit():
    rng = np.random.default_rng(50)
    A = rng.standard_normal((NE, 6, NB)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((NE, NB)).astype(np.float32))
    want = bm.make_table_apply(A, store_dtype=torch.bfloat16, device="cpu")(x)
    f = bm.make_table_apply(A, store_dtype=torch.bfloat16, device="cpu",
                            split_k=2, tile=STILE)
    assert isinstance(f.table, list) and len(f.table) == 2
    assert f.table[0].shape == (3 * STILE, 6, NB)
    _assert_within(f(x).numpy(), want.numpy(), _row_scale(A, x.numpy()),
                   1e-6)


# segments (count, d) of the segment tests: d not a multiple of 8 entries
# (so neither of 16 bytes of bf16 nor of 32 of f32), a one-block segment,
# d = 16 (rows of two or four 16-byte vectors), and room for two zero
# blocks after the last
SEGMENTS = [(5, 7), (1, 13), (9, 5), (3, 12), (4, 1), (6, 16)]
SEG_NBLK, SEG_WIDTH = 30, 16


def _segment_blocks(seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((c, d, d)))
            for c, d in SEGMENTS]


@pytest.mark.parametrize("store,compute", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.float64)])
def test_block_mv_segments_plain_equals_padded(store, compute):
    """The segment apply's plain version against ``block_mv_plain`` on the
    padded table the segments stand for: within 1e-6 (f32 arithmetic) or
    1e-14 (f64) of sum_j |a_ij x_j| -- einsums over d and over width
    columns, the extra terms products with zeros -- and its pad entries
    exactly 0.  The padded table holds the blocks as stored, each start of
    the packed table is 16-byte aligned, and the stored entries are the
    real blocks and the alignment gaps."""
    blocks = _segment_blocks(70)
    f = bm.make_segment_apply(blocks, SEG_NBLK, SEG_WIDTH, store, "cpu",
                              compute)
    T = f.table
    assert isinstance(T, bm.SegmentTable) and T.nreal == SEG_NBLK - 2
    assert T.data.dtype == (torch.float64 if compute == torch.float64
                            else store)
    assert all(off % 8 == 0 for off in T.desc[:, 0])
    real = sum(c * d * d for c, d in SEGMENTS)
    assert real <= T.data.numel() < real + 8 * len(SEGMENTS)
    assert T.real_bytes == real * T.data.element_size()
    P = T.padded()
    assert P.shape == (SEG_NBLK, SEG_WIDTH, SEG_WIDTH)
    first = 0
    for B in blocks:
        c, d, _ = B.shape
        assert torch.equal(P[first: first + c, :d, :d],
                           B.to(store).to(P.dtype))
        first += c
    rng = np.random.default_rng(71)
    x = torch.from_numpy(rng.standard_normal((SEG_NBLK, SEG_WIDTH))).to(
        compute)
    got = f(x)
    want = bm.block_mv_plain(P, x)
    assert got.dtype == compute and got.shape == (SEG_NBLK, SEG_WIDTH)
    tol = 1e-14 if compute == torch.float64 else 1e-6
    _assert_within(got.numpy(), want.numpy(),
                   _row_scale(P.double().numpy(), x.double().numpy()), tol)
    first = 0
    for c, d in SEGMENTS:
        assert not got[first: first + c, d:].any()
        first += c
    assert not got[first:].any()


@pytest.mark.parametrize("case", [
    "gap", "overlap", "misaligned", "wide", "empty", "beyond", "too_many",
    "shape", "not_1d"])
def test_segment_table_rejects_bad_descriptors(case):
    """Descriptors that break the layout the kernel reads are refused
    when the table is made, so no wrapper can be handed them."""
    data = torch.zeros(200)
    desc = [[0, 0, 2, 3], [24, 2, 3, 4], [72, 5, 1, 5]]
    nblk, width = 7, 5
    if case == "gap":
        desc[1][1] = 3
    elif case == "overlap":
        desc[1][0] = 16
    elif case == "misaligned":
        desc[2][0] = 76
    elif case == "wide":
        desc[2][3] = 6
    elif case == "empty":
        desc[1][2] = 0
    elif case == "beyond":
        desc[2][0] = 184
    elif case == "too_many":
        nblk = 5
    elif case == "shape":
        desc = [row[:3] for row in desc]
    else:
        data = torch.zeros((10, 20))
    bm.SegmentTable(torch.zeros(200), [[0, 0, 2, 3], [24, 2, 3, 4],
                                       [72, 5, 1, 5]], 7, 5)
    with pytest.raises(ValueError):
        bm.SegmentTable(data, desc, nblk, width)


def test_block_mv_segments_rejects_bad_inputs():
    T = bm.pack_segments(_segment_blocks(72), SEG_NBLK, SEG_WIDTH,
                         device="cpu")
    x = torch.zeros((SEG_NBLK, SEG_WIDTH))
    bm.block_mv_segments(T, x)
    with pytest.raises(TypeError):
        bm.block_mv_segments(T.padded(), x)
    with pytest.raises(ValueError):
        bm.block_mv_segments(T, torch.zeros((SEG_NBLK, SEG_WIDTH + 1)))
    with pytest.raises(ValueError):
        bm.block_mv_segments(T, torch.zeros((SEG_WIDTH, SEG_NBLK)).T)
    with pytest.raises(TypeError):
        bm.block_mv_segments(T, x.double())


@pytest.fixture(scope="module")
def layout():
    """The port's face-block layout on the maxh=0.6 channel."""
    from navier_stokes_tpu_torch.fem.hdiv3d import HDiv3D
    from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh_3d
    from navier_stokes_tpu_torch.models.stokes_hybrid3d import (
        HybridVelocitySpace3D,
        VectorFacet3D,
    )
    from navier_stokes_tpu_torch.ops.faceblock import FaceBlockLayout

    mesh = channel_with_cylinder_mesh_3d(0.6)
    V = HDiv3D(mesh, 2, dirichlet="inlet|wall|cyl")
    F = VectorFacet3D(mesh, 1, dirichlet="inlet|wall|cyl|outlet")
    return FaceBlockLayout(HybridVelocitySpace3D(V, F), "cpu")


@pytest.mark.parametrize("op", ["A32", "A_ds", "B_ds", "BT_ds"])
def test_face_block_applies_splitk_equal_unsplit(layout, op):
    """elem_apply_tiled (kernel 6), elem_apply_comp and rect_apply_comp
    (kernel 7) at split_k=2 against split_k=1 on the CPU."""
    lay = layout
    rng = np.random.default_rng(60)
    if op in ("A32", "A_ds"):
        A64 = rng.standard_normal((lay.ne, lay.nb, lay.nb))
    else:
        A64 = rng.standard_normal((lay.ne, 4, lay.nb))
    hi = A64.astype(np.float32)
    lo = (A64 - hi.astype(np.float64)).astype(np.float32)
    one = lay.pack_elem_tables([hi, lo])
    two = lay.pack_elem_tables([hi, lo], split_k=2)
    if op == "A32":
        u = torch.from_numpy(rng.standard_normal(lay.n).astype(np.float32))
        want = lay.elem_apply_tiled(one)(u)
        got = lay.elem_apply_tiled(two)(u)
    elif op == "A_ds":
        u = torch.from_numpy(rng.standard_normal(lay.n))
        want = lay.elem_apply_comp(*one)(u)
        got = lay.elem_apply_comp(*two)(u)
    else:
        eldofs_p = np.arange(lay.ne * 4).reshape(lay.ne, 4)
        B1 = lay.rect_apply_comp(*one, eldofs_p)
        B2 = lay.rect_apply_comp(*one, eldofs_p, split_k=2)
        i = 0 if op == "B_ds" else 1
        n = lay.n if op == "B_ds" else lay.ne * 4
        u = torch.from_numpy(rng.standard_normal(n))
        want, got = B1[i](u), B2[i](u)
    if op == "A32":
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-6 * scale
    else:  # the compensated recurrence, entry by entry: bitwise
        assert torch.equal(got, want)


def test_split_f64_is_exact_to_f32_squared():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(1000) * 1e3)
    hi, lo = bm.split_f64(x)
    assert hi.dtype == lo.dtype == torch.float32
    err = (hi.double() + lo.double() - x).abs() / x.abs()
    assert float(err.max()) < 2.0**-46


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguous", "x_dtype"])
def test_wrappers_reject_bad_inputs(case):
    A = torch.zeros((4, 3, 5))
    x = torch.zeros((4, 5))
    if case == "dtype":
        A = A.double()
    elif case == "shape":
        x = torch.zeros((4, 3))
    elif case == "contiguous":
        A = torch.zeros((4, 5, 3)).transpose(1, 2)
    else:
        x = x.double()
    with pytest.raises((TypeError, ValueError)):
        bm.block_mv(A, x)
    with pytest.raises((TypeError, ValueError)):
        bm.block_mv2(A, A, x)


def test_cpu_tensors_launch_no_kernel():
    bm.reset_launches()
    A = torch.ones((3, 2, 2))
    x = torch.ones((3, 2))
    bm.block_mv(A, x)
    bm.block_mv2(A, A, x)
    bm.block_mv_comp(A, A, x, x)
    subs = bm.pack_splitk(A, 2, 2)
    bm.block_mv_splitk(subs, x, 2)
    bm.block_mv2_splitk(subs, subs, x, 2)
    bm.block_mv_comp_splitk(subs, subs, x, x, 2)
    bm.block_mv_ds(A, A, x, x)
    batched_local_matvec(A, x)
    batched_local_matvec(A.double(), x.double())
    stream_mv.block_mv_rows(A, x, 4)
    stream_mv.block_mv_mega(A, x, 2, 2)
    stream_mv.block_mv_ring(A, x, 2, 2)
    stream_mv.block_mv_soa(A.permute(1, 2, 0).contiguous(),
                           x.T.contiguous())
    assert set(bm.LAUNCHES) == {
        "block_mv", "block_mv2", "block_mv_comp", "block_mv_splitk",
        "block_mv2_splitk", "block_mv_comp_splitk", "block_mv_ds",
        "batched_local_matvec", "batched_local_matvec_f64", "block_mv_rows",
        "block_mv_mega",
        "block_mv_ring", "block_mv_soa"}
    assert all(v == 0 for v in bm.LAUNCHES.values())


def test_entry_points_refuse_to_run_on_cpu_unasked():
    """Without a GPU, an entry point called without ``device="cpu"`` raises
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from navier_stokes_tpu_torch.device import resolve_device
    from navier_stokes_tpu_torch.flagship import build_model

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        build_model(0.6)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")

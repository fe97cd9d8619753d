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

The kernels themselves run only on the card: ``test_kernels_match_plain_on_
card`` carries the ``cuda`` marker and skips without a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
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


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On the card: each kernel against its plain version on the same
    inputs (runs where a CUDA device and nvcc are present)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for shape, dt in (((200, 54, 54), torch.float32), ((300, 6, 48),
                      torch.bfloat16), ((5, 3, 7), torch.bfloat16)):
        A = torch.randn(shape, generator=gen, device=dev).to(dt)
        x = torch.randn(shape[0], shape[2], generator=gen, device=dev)
        scale = torch.einsum("bmk,bk->bm", A.double().abs(), x.double().abs())
        d = (bm.block_mv(A, x) - bm.block_mv_plain(A, x)).abs()
        assert float((d / scale).max()) <= 1e-5
    A64, x64 = (torch.from_numpy(a).to(dev) for a in _cancellation_case())
    hi = A64.float()
    lo = (A64 - hi.double()).float()
    x = x64.float()
    scale = torch.einsum("bmk,bk->bm", A64.abs(), x.double().abs())
    d = (bm.block_mv2(hi, lo, x) - bm.block_mv2_plain(hi, lo, x)).abs()
    assert float((d / scale).max()) <= 1e-5
    xh, xl = bm.split_f64(x64)
    yh, yl = bm.block_mv_comp(hi, lo, xh, xl)
    rh, rl = bm.block_mv_comp_plain(hi, lo, xh, xl)
    assert torch.equal(yh, rh) and torch.equal(yl, rl)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_splitk_kernels_match_plain_on_card(k):
    """On the card: each split-k kernel against its plain version, and
    bitwise against its unsplit kernel on the same table; kernel 7 also at
    the edges of its CTA stretches (``EDGE_SPLITK``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(k)
    for shape, dt in (((300, 54, 54), torch.float32), ((301, 6, 48),
                      torch.bfloat16), ((5, 3, 7), torch.bfloat16)):
        A = torch.randn(shape, generator=gen, device=dev).to(dt)
        x = torch.randn(shape[0], shape[2], generator=gen, device=dev)
        subs = bm.pack_splitk(A, k, STILE)
        y = bm.block_mv_splitk(subs, x, STILE)
        scale = torch.einsum("bmk,bk->bm", A.double().abs(), x.double().abs())
        d = (y - bm.block_mv_splitk_plain(subs, x, STILE)).abs()
        assert float((d / scale).max()) <= 1e-5
        assert torch.equal(y, bm.block_mv(A, x))
    A64, x64 = (torch.from_numpy(a).to(dev) for a in _cancellation_case())
    hi = A64.float()
    lo = (A64 - hi.double()).float()
    hs, ls = bm.pack_splitk(hi, k, STILE), bm.pack_splitk(lo, k, STILE)
    x = x64.float()
    scale = torch.einsum("bmk,bk->bm", A64.abs(), x.double().abs())
    y2 = bm.block_mv2_splitk(hs, ls, x, STILE)
    d = (y2 - bm.block_mv2_splitk_plain(hs, ls, x, STILE)).abs()
    assert float((d / scale).max()) <= 1e-5
    assert torch.equal(y2, bm.block_mv2(hi, lo, x))
    xh, xl = bm.split_f64(x64)
    yh, yl = bm.block_mv_comp_splitk(hs, ls, xh, xl, STILE)
    rh, rl = bm.block_mv_comp_splitk_plain(hs, ls, xh, xl, STILE)
    assert torch.equal(yh, rh) and torch.equal(yl, rl)
    uh, ul = bm.block_mv_comp(hi, lo, xh, xl)
    assert torch.equal(yh, uh) and torch.equal(yl, ul)
    for nblk, m, kk, tile in EDGE_SPLITK:
        A64 = torch.randn((nblk, m, kk), generator=gen, device=dev,
                          dtype=torch.float64)
        x64 = torch.randn((nblk, kk), generator=gen, device=dev,
                          dtype=torch.float64)
        hi, lo = bm.split_f64(A64)
        xh, xl = bm.split_f64(x64)
        hs, ls = bm.pack_splitk(hi, k, tile), bm.pack_splitk(lo, k, tile)
        yh, yl = bm.block_mv_comp_splitk(hs, ls, xh, xl, tile)
        rh, rl = bm.block_mv_comp_splitk_plain(hs, ls, xh, xl, tile)
        assert torch.equal(yh, rh) and torch.equal(yl, rl)
        uh, ul = bm.block_mv_comp(hi, lo, xh, xl)
        assert torch.equal(yh, uh) and torch.equal(yl, ul)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_block_mv_comp_equals_splitk_on_card():
    """On the card: kernel 4, which is kernel 7's kernel at one sub-table,
    bitwise equal to its plain version and to kernel 7 at k = 2, 4, 8 on
    the edge shapes (``EDGE_SPLITK``); a table view that does not start on
    a 16-byte boundary is refused, as the bulk copies need."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    for nblk, m, kk, tile in EDGE_SPLITK:
        A64 = torch.randn((nblk, m, kk), generator=gen, device=dev,
                          dtype=torch.float64)
        x64 = torch.randn((nblk, kk), generator=gen, device=dev,
                          dtype=torch.float64)
        hi, lo = bm.split_f64(A64)
        xh, xl = bm.split_f64(x64)
        yh, yl = bm.block_mv_comp(hi, lo, xh, xl)
        rh, rl = bm.block_mv_comp_plain(hi, lo, xh, xl)
        assert torch.equal(yh, rh) and torch.equal(yl, rl)
        for k in (2, 4, 8):
            hs, ls = bm.pack_splitk(hi, k, tile), bm.pack_splitk(lo, k, tile)
            sh, sl = bm.block_mv_comp_splitk(hs, ls, xh, xl, tile)
            assert torch.equal(yh, sh) and torch.equal(yl, sl)
    torch.cuda.synchronize()
    nblk, m, kk = 300, 54, 54
    flat = torch.zeros(1 + nblk * m * kk, device=dev)
    view = flat[1:].view(nblk, m, kk)  # 4 bytes past a 16-byte boundary
    table = torch.zeros((nblk, m, kk), device=dev)
    x = torch.zeros((nblk, kk), device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        bm.block_mv_comp(view, table, x, x)
    with pytest.raises(ValueError, match="16-byte"):
        bm.block_mv_comp(table, view, x, x)


# (nblk, m, k, tile) of the card tests of kernels 5 and 6 beyond
# EDGE_SPLITK: tiles of 2 to 256 blocks, rows of 1 to 132 entries, f32 rows
# of whole 16-byte vectors (k = 48: read a vector at a time) and not
CARD_SPLITK = [(7, 1, 1, 2), (130, 12, 9, 256), (600, 48, 48, 64),
               (257, 6, 48, 128), (90, 48, 6, 5), (41, 132, 132, 4),
               (1000, 6, 6, 256)]


def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_mv_splitk_equals_block_mv_on_card(dtype):
    """On the card: kernel 5 BITWISE equal to block_mv on the unsplit table
    at k = 1..8, for tiles of 2 to 256 blocks, stretches across tile
    boundaries and sub-tables of zero pad only, and within 1e-5 of
    sum_j |a_ij x_j| of its plain version."""
    _card_or_skip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for nblk, m, kk, tile in EDGE_SPLITK + CARD_SPLITK:
        A = torch.randn((nblk, m, kk), generator=gen, device="cuda").to(dtype)
        x = torch.randn((nblk, kk), generator=gen, device="cuda")
        want = bm.block_mv(A, x)
        scale = torch.einsum("bmk,bk->bm", A.double().abs(),
                             x.double().abs()).clamp_min(1e-300)
        for k in range(1, 9):
            subs = bm.pack_splitk(A, k, tile)
            y = bm.block_mv_splitk(subs, x, tile)
            d = (y - bm.block_mv_splitk_plain(subs, x, tile)).abs()
            assert torch.equal(y, want), (nblk, m, kk, tile, k)
            assert float((d / scale).max()) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_block_mv2_splitk_equals_block_mv2_on_card():
    """On the card: kernel 6 BITWISE equal to block_mv2 on the unsplit pair
    at k = 1..8 on the shapes of the kernel-5 card test, and within 1e-5
    of sum_j |a_ij x_j| of its plain version."""
    _card_or_skip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    for nblk, m, kk, tile in EDGE_SPLITK + CARD_SPLITK:
        A64 = torch.randn((nblk, m, kk), generator=gen, device="cuda",
                          dtype=torch.float64)
        hi, lo = bm.split_f64(A64)
        x = torch.randn((nblk, kk), generator=gen, device="cuda")
        want = bm.block_mv2(hi, lo, x)
        scale = torch.einsum("bmk,bk->bm", A64.abs(),
                             x.double().abs()).clamp_min(1e-300)
        for k in range(1, 9):
            hs, ls = bm.pack_splitk(hi, k, tile), bm.pack_splitk(lo, k, tile)
            y = bm.block_mv2_splitk(hs, ls, x, tile)
            d = (y - bm.block_mv2_splitk_plain(hs, ls, x, tile)).abs()
            assert torch.equal(y, want), (nblk, m, kk, tile, k)
            assert float((d / scale).max()) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_splitk_refuses_misaligned_sub_table_on_card():
    """On the card: a sub-table view that does not start on a 16-byte
    boundary is refused by every split-k wrapper, as the bulk copies need,
    and by the C entry itself."""
    _card_or_skip()
    nblk, m, kk = 64, 6, 8
    flat = torch.zeros(2 + nblk * m * kk, device="cuda")
    view = flat[1:1 + nblk * m * kk].view(nblk, m, kk)  # 4 bytes off
    good = torch.zeros((nblk, m, kk), device="cuda")
    flat16 = torch.zeros(8 + nblk * m * kk, device="cuda",
                         dtype=torch.bfloat16)
    view16 = flat16[4:4 + nblk * m * kk].view(nblk, m, kk)  # 8 bytes off
    x = torch.zeros((nblk, kk), device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        bm.block_mv_splitk([good, view], x, 32)
    with pytest.raises(ValueError, match="16-byte"):
        bm.block_mv_splitk([view16], x, 64)
    with pytest.raises(ValueError, match="16-byte"):
        bm.block_mv2_splitk([view], [good], x, 64)
    with pytest.raises(ValueError, match="16-byte"):
        bm.block_mv_comp_splitk([good], [view], x, x, 64)
    y = torch.empty((nblk, m), device="cuda")
    rc = bm.load_library().nstt_block_mv_splitk_f32(
        bm._ptrs([view]), 1, x.data_ptr(), y.data_ptr(), nblk, m, kk, nblk,
        nblk, torch.cuda.current_stream().cuda_stream)
    assert rc != 0


# (nblk, m, k) edges of kernels 1 and 2 at one sub-table: m * k not a whole
# number of 16-byte units in either type, odd k in bf16, one block, one
# row, a CTA's stretch ending mid-block, blocks wider than a CTA's rows,
# rows of an even number of 16-byte vectors (k = 8, 16, 48, 96)
EDGE_UNSPLIT = [(1, 1, 1), (1, 54, 54), (37, 6, 7), (301, 4, 54),
                (45, 54, 4), (5, 3, 7), (19, 5, 3), (203, 7, 9),
                (7, 132, 132), (1000, 6, 6), (3, 300, 11), (130, 12, 96),
                (3, 5, 48), (7, 1, 16), (33, 3, 8)]


@pytest.mark.cuda
def test_block_mv_and_block_mv2_edges_on_card():
    """On the card: kernels 1 (f32 and bf16) and 2 at the edges of their
    CTA stretches within 1e-5 of sum_j |a_ij x_j| of their plain versions,
    and BITWISE equal to kernels 5 and 6 at k = 2 and 4 on the same
    tables."""
    _card_or_skip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for nblk, m, kk in EDGE_UNSPLIT:
        A64 = torch.randn((nblk, m, kk), generator=gen, device="cuda",
                          dtype=torch.float64)
        hi, lo = bm.split_f64(A64)
        x = torch.randn((nblk, kk), generator=gen, device="cuda")
        scale = torch.einsum("bmk,bk->bm", A64.abs(),
                             x.double().abs()).clamp_min(1e-300)
        for A in (hi, hi.to(torch.bfloat16)):
            y = bm.block_mv(A, x)
            d = (y - bm.block_mv_plain(A, x)).abs()
            assert float((d / scale).max()) <= 1e-5, (nblk, m, kk, A.dtype)
            for k in (2, 4):
                subs = bm.pack_splitk(A, k, 4)
                assert torch.equal(y, bm.block_mv_splitk(subs, x, 4))
        y2 = bm.block_mv2(hi, lo, x)
        d = (y2 - bm.block_mv2_plain(hi, lo, x)).abs()
        assert float((d / scale).max()) <= 1e-5, (nblk, m, kk)
        for k in (2, 4):
            hs, ls = bm.pack_splitk(hi, k, 4), bm.pack_splitk(lo, k, 4)
            assert torch.equal(y2, bm.block_mv2_splitk(hs, ls, x, 4))
    torch.cuda.synchronize()


# the three tables kernel 3 streams in the [ds] phase at maxh=0.09: A_ds,
# B_ds and BT_ds (nblk, m, k)
DS_BENCH = [(7740, 54, 54), (7740, 4, 54), (7740, 54, 4)]


@pytest.mark.cuda
def test_block_mv_ds_equals_block_mv_on_card():
    """On the card: each of kernel 3's three outputs BITWISE equal to
    block_mv on its (table, vector) pair -- A_hi x_hi, A_hi x_lo, A_lo x_hi
    -- at the edges of the CTA stretches (``EDGE_UNSPLIT``) and on the
    shapes of the [ds] phase's tables, and within 2e-6 of sum_j |a_ij x_j|
    of its plain version."""
    _card_or_skip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for nblk, m, kk in EDGE_UNSPLIT + DS_BENCH:
        A64 = torch.randn((nblk, m, kk), generator=gen, device="cuda",
                          dtype=torch.float64)
        x64 = torch.randn((nblk, kk), generator=gen, device="cuda",
                          dtype=torch.float64)
        hi, lo = bm.split_f64(A64)
        xh, xl = bm.split_f64(x64)
        got = bm.block_mv_ds(hi, lo, xh, xl)
        ref = bm.block_mv_ds_plain(hi, lo, xh, xl)
        scale = torch.einsum("bmk,bk->bm", A64.abs(),
                             x64.abs()).clamp_min(1e-300)
        for y, (A, x), r in zip(got, ((hi, xh), (hi, xl), (lo, xh)), ref):
            assert torch.equal(y, bm.block_mv(A, x)), (nblk, m, kk)
            d = (y - r).abs().double()
            assert float((d / scale).max()) <= 2e-6, (nblk, m, kk)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_mv_segments_equals_block_mv_on_padded_on_card(dtype):
    """On the card: the segment kernel EQUAL as values (torch.equal) to
    block_mv on the padded table the segments stand for, on the segments
    of the CPU test and on GS-like ones (d = 12 nf, nf = 3..11, up to
    several hundred blocks each), and within 1e-5 of sum_j |a_ij x_j| of
    its plain version."""
    _card_or_skip()
    rng = np.random.default_rng(8)
    gs = [(int(rng.integers(1, 400)), 12 * nf) for nf in range(3, 12)]
    for segs, width in ((SEGMENTS, SEG_WIDTH), (gs, 132)):
        blocks = [torch.from_numpy(rng.standard_normal((c, d, d)))
                  for c, d in segs]
        nblk = sum(c for c, _ in segs) + 1
        T = bm.pack_segments(blocks, nblk, width, dtype, "cuda")
        x = torch.from_numpy(rng.standard_normal((nblk, width)).astype(
            np.float32)).cuda()
        y = bm.block_mv_segments(T, x)
        P = T.padded()
        assert torch.equal(y, bm.block_mv(P, x))
        d = (y - bm.block_mv_segments_plain(T, x)).abs().double()
        scale = torch.einsum("bmk,bk->bm", P.double().abs(),
                             x.double().abs()).clamp_min(1e-300)
        assert float((d / scale).max()) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_unsplit_kernels_refuse_misaligned_table_on_card():
    """On the card: block_mv, block_mv2, block_mv_ds and block_mv_segments
    refuse a table that does not start on a 16-byte boundary (their bulk
    copies start there), and so do their C entries."""
    _card_or_skip()
    nblk, m, kk = 64, 6, 8
    flat = torch.zeros(2 + nblk * m * kk, device="cuda")
    view = flat[1:1 + nblk * m * kk].view(nblk, m, kk)  # 4 bytes off
    good = torch.zeros((nblk, m, kk), device="cuda")
    x = torch.zeros((nblk, kk), device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        bm.block_mv(view, x)
    with pytest.raises(ValueError, match="16-byte"):
        bm.block_mv2(good, view, x)
    with pytest.raises(ValueError, match="16-byte"):
        bm.block_mv_ds(good, view, x, x)
    with pytest.raises(ValueError, match="16-byte"):
        bm.block_mv_ds(view, good, x, x)
    T = bm.pack_segments([torch.zeros((2, 3, 3))], 3, 3, device="cuda")
    Tv = bm.SegmentTable(flat[1:1 + T.data.numel()], T.desc, 3, 3)
    with pytest.raises(ValueError, match="16-byte"):
        bm.block_mv_segments(Tv, torch.zeros((3, 3), device="cuda"))
    y = torch.empty((nblk, m), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    lib = bm.load_library()
    assert lib.nstt_block_mv_f32(view.data_ptr(), x.data_ptr(), y.data_ptr(),
                                 nblk, m, kk, stream) != 0
    y2, y3 = torch.empty_like(y), torch.empty_like(y)
    for a_hi, a_lo in ((view, good), (good, view)):
        assert lib.nstt_block_mv_ds_f32(
            a_hi.data_ptr(), a_lo.data_ptr(), x.data_ptr(), x.data_ptr(),
            y.data_ptr(), y2.data_ptr(), y3.data_ptr(), nblk, m, kk,
            stream) != 0
    xs, ys = torch.zeros((3, 3), device="cuda"), torch.empty((3, 3),
                                                             device="cuda")
    assert lib.nstt_block_mv_seg_f32(
        Tv.data.data_ptr(), Tv.data.numel(), Tv.desc.ctypes.data,
        Tv.desc_dev.data_ptr(), 1, xs.data_ptr(), ys.data_ptr(), 3, 3,
        stream) != 0

"""The port's card-only tests: each hand-written kernel against its plain
PyTorch version, and the split-k, segment and stream kernels bitwise
against ``block_mv``, on CUDA tensors.

Every test carries the ``cuda`` marker and skips without a CUDA device (the
CUDA kernels have no CPU mode).  The file imports neither ``jax`` nor
``navier_stokes_tpu``, so that it runs where only PyTorch is installed, as
on the card's machine, without the repository's ``tests/conftest.py``
(which configures JAX)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs that command as its ``[cuda-tests]`` phase.  The
CPU parity tests of the same wrappers are in ``tests/test_torch_block_mv.py``,
``test_torch_local_mv.py``, ``test_torch_stream_mv.py`` and
``test_torch_timers.py``.
"""

import numpy as np
import pytest
import torch

from navier_stokes_tpu_torch.ops import block_mv as bm
from navier_stokes_tpu_torch.ops import stream_mv as sm
from navier_stokes_tpu_torch.ops.local_mv import (
    batched_local_matvec,
    batched_local_matvec_plain,
)
from navier_stokes_tpu_torch.utils.timers import KernelTimer, Timer

# -- shapes and cases shared with the CPU tests of the same wrappers ---------

NE, NB = 37, 14  # deliberately non-multiple ne, as test_torch_block_mv.py
STILE = 8  # split-k tile: 5 tiles, which neither k = 2 nor k = 3 divides
# The edges of the split-k kernels' CTA stretches (kernels 5-7; the same
# shapes as chip_smoke.EDGE_SPLITK), (nblk, m, k, tile)
EDGE_SPLITK = [(37, 6, 7, 8), (300, 54, 54, 8), (301, 4, 54, 16),
               (45, 54, 4, 3), (5, 3, 7, 2), (19, 5, 3, 4), (203, 7, 9, 16)]
SEGMENTS = [(5, 7), (1, 13), (9, 5), (3, 12), (4, 1), (6, 16)]
SEG_WIDTH = 16
# kernel 8 (test_torch_local_mv.py): tolerances and the edges of its CTA
# stretches, (ne, nb, offset in elements of a contiguous view into its
# allocation)
TOL = {"float32": 2e-6, "float64": 1e-13}
EDGE_LOCAL = [(700, 54, 0), (3001, 4, 0), (77, 12, 0), (77, 13, 0),
              (1, 1, 0), (1, 54, 0), (5, 130, 0), (700, 54, 1), (77, 13, 1),
              (3001, 4, 2), (5, 130, 3), (1, 1, 1)]


def _cancellation_case(seed=11):
    """~1e5 row cancellation (test_pallas_mv.py:125-151)."""
    rng = np.random.default_rng(seed)
    A64 = rng.standard_normal((NE, NB, NB))
    x64 = rng.standard_normal((NE, NB))
    A64[:, :, 0] *= 1e5
    A64[:, :, 1] = -A64[:, :, 0] * (x64[:, 0] / x64[:, 1])[:, None]
    return A64, x64


# -- block_mv, block_mv2, block_mv_ds, the split-k and segment kernels ---


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

# -- batched_local_matvec, and block_mv_ds on its tables -----------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_local_matvec_kernel_matches_plain_on_card(dtype):
    """On the card: the kernel against its plain version at the transient
    step's block sizes (54 x 54 element blocks, 4 x 4 pressure blocks), at
    sizes that leave a ragged last tile, and at the edges of its CTA
    stretches (``EDGE_LOCAL``, views at 4-, 8- and 12-byte offsets)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bm.reset_launches()
    shapes = [(ne, nb, 0) for ne, nb in ((700, 54), (3001, 4), (77, 12),
                                         (1, 1), (5, 130))] + EDGE_LOCAL
    for ne, nb, off in shapes:
        fa = torch.randn(off + ne * nb * nb, generator=gen, device="cuda",
                         dtype=dt)
        fu = torch.randn(off + ne * nb, generator=gen, device="cuda",
                         dtype=dt)
        A, u = fa[off:].view(ne, nb, nb), fu[off:].view(ne, nb)
        y = batched_local_matvec(A, u)
        scale = torch.einsum("eij,ej->ei", A.double().abs(), u.double().abs())
        d = (y - batched_local_matvec_plain(A, u)).abs().double()
        assert float((d / scale).max()) <= TOL[dtype]
    torch.cuda.synchronize()
    key = ("batched_local_matvec" if dtype == "float32"
           else "batched_local_matvec_f64")
    assert bm.LAUNCHES[key] == len(shapes)


@pytest.mark.cuda
def test_block_mv_ds_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape in ((300, 54, 54), (301, 4, 54), (299, 54, 4), (5, 3, 7)):
        A64 = torch.randn(shape, generator=gen, device="cuda",
                          dtype=torch.float64)
        x64 = torch.randn((shape[0], shape[2]), generator=gen, device="cuda",
                          dtype=torch.float64)
        hi, lo = bm.split_f64(A64)
        xh, xl = bm.split_f64(x64)
        got = bm.block_mv_ds(hi, lo, xh, xl)
        ref = bm.block_mv_ds_plain(hi, lo, xh, xl)
        scale = torch.einsum("bmk,bk->bm", A64.abs(), x64.abs())
        for g, r in zip(got, ref):
            assert float(((g - r).abs().double() / scale).max()) <= 2e-6
    torch.cuda.synchronize()

# -- the microbenchmark kernels (ops/stream_mv.py) ----------------------


@pytest.mark.cuda
def test_stream_mv_kernels_match_plain_on_card():
    """On the card: every kernel against its plain version and bitwise
    against ``block_mv``, at the bench block and at ragged sizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for nblk, m, k in ((700, 54, 54), (1001, 7, 13), (333, 54, 12),
                       (301, 4, 53)):
        A = torch.randn((nblk, m, k), generator=gen, device="cuda")
        x = torch.randn((nblk, k), generator=gen, device="cuda")
        ref, want = bm.block_mv(A, x), bm.block_mv_plain(A, x)
        got = [sm.block_mv_rows(A, x, r) for r in (0, 1, 5, 64, 432, 864)]
        got += [sm.make_bmv_splitk_seq(A, ns, 128)(x) for ns in (2, 8)]
        got += [sm.block_mv_mega(A, x, kt, 4 * r)
                for kt, r in ((1, 1), (2, 8), (4, 32))]
        got += [sm.block_mv_ring(A, x, nbuf, 4 * r)
                for nbuf, r in ((1, 1), (2, 16), (8, 16), (3, 5))]
        torch.cuda.synchronize()
        for y in got:
            assert torch.equal(y, ref)
            assert float((y - want).abs().max()) <= 1e-4
    # block_mv_soa: one partial element tile, nb = 1 and 64; bitwise equal
    # to block_mv on the AoS table.  The tensor maps need 16-byte strides,
    # so ne % 4 == 0 (pack_soa pads to 256): 333 is refused
    for nb, ne in ((54, 7936), (7, 1000), (64, 336), (7, 4), (1, 260),
                   (64, 7936)):
        A2 = torch.randn((nb, nb, ne), generator=gen, device="cuda")
        uT = torch.randn((nb, ne), generator=gen, device="cuda")
        y = sm.block_mv_soa(A2, uT)
        torch.cuda.synchronize()
        assert float((y - sm.block_mv_soa_plain(A2, uT)).abs().max()) <= 1e-4
        ref = bm.block_mv(A2.permute(2, 0, 1).contiguous(), uT.T.contiguous())
        assert torch.equal(y.T, ref), (nb, ne)
    with pytest.raises(ValueError):
        sm.block_mv_soa(torch.zeros((64, 64, 333), device="cuda"),
                        torch.zeros((64, 333), device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 12, 64, 128])
def test_block_mv_ring_equals_block_mv_on_card(rows):
    """On the card: the producer/consumer ring at every depth 1..8 bitwise
    equal to ``block_mv`` and within 1e-4 of the plain version -- on the
    bench block (its last stage ragged at 64 and 128 rows), on 7 x 13
    blocks (a ragged last stage at every row count, a table tail that is
    not whole 16-byte units, x stretches starting anywhere in a 16-byte
    unit), with x a view 0 or 4 bytes past a 16-byte boundary, and on a
    table of fewer tiles than the card holds CTAs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(rows)
    for nblk, m, k in ((700, 54, 54), (1001, 7, 13), (3, 5, 4)):
        A = torch.randn((nblk, m, k), generator=gen, device="cuda")
        for off in (0, 1):
            flat = torch.randn(off + nblk * k, generator=gen, device="cuda")
            x = flat[off:].view(nblk, k)
            ref, want = bm.block_mv(A, x), bm.block_mv_plain(A, x)
            for nbuf in range(1, 9):
                y = sm.block_mv_ring(A, x, nbuf, rows)
                torch.cuda.synchronize()
                assert torch.equal(y, ref), (nblk, m, k, off, nbuf)
                assert float((y - want).abs().max()) <= 1e-4

# -- KernelTimer and the device spin ------------------------------------


@pytest.mark.cuda
def test_kernel_timer_and_device_spin_on_card():
    """On the card: the spin keeps the stream busy in proportion to the
    cycles it is given, KernelTimer returns a median time, and Timer's
    Stop fences on a CUDA tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spin is a CUDA kernel")
    from navier_stokes_tpu_torch.ops.block_mv import device_spin

    def spin_ms(cycles):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        device_spin(cycles)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e)

    spin_ms(1000)
    short, long = spin_ms(10_000_000), spin_ms(20_000_000)
    assert 1.0 < short < long  # 10 M cycles: about 5 ms at 1.98 GHz
    assert 1.6 <= long / short <= 2.4
    a = torch.randn(4096, 4096, device="cuda")
    ms = KernelTimer(reps=5)(lambda: a @ a)
    assert 0 < ms < 1000
    t = Timer("matmul").Start()
    y = a @ a
    assert t.Stop(y) == t.time > 0


# -- the 3D HDG model's vertex-star tables and the deterministic scatter ----

# vertex-star blocks of the 3D HDG channel: up to 1,056 dofs at maxh 0.09
# (mean 597); (ne, nb, offset in elements)
STAR_BLOCKS = [(3, 1056, 0), (5, 600, 1), (2, 1056, 3), (9, 97, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_local_matvec_vertex_star_blocks_on_card(dtype):
    """On the card: kernel 8 on blocks as wide as the HDG vertex stars
    (the launch plan's fewest rows per CTA), against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for ne, nb, off in STAR_BLOCKS:
        fa = torch.randn(off + ne * nb * nb, generator=gen, device="cuda",
                         dtype=dt)
        fu = torch.randn(off + ne * nb, generator=gen, device="cuda",
                         dtype=dt)
        A, u = fa[off:].view(ne, nb, nb), fu[off:].view(ne, nb)
        y = batched_local_matvec(A, u)
        scale = torch.einsum("eij,ej->ei", A.double().abs(), u.double().abs())
        d = (y - batched_local_matvec_plain(A, u)).abs().double()
        assert float((d / scale).max()) <= TOL[dtype]


@pytest.mark.cuda
def test_block_mv_vertex_star_blocks_on_card():
    """On the card: kernel 1 (the f32 block-Jacobi route) on blocks as wide
    as the HDG vertex stars, against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for nblk, nb in ((3, 1056), (7, 600), (4, 1055)):
        A = torch.randn((nblk, nb, nb), generator=gen, device="cuda")
        x = torch.randn((nblk, nb), generator=gen, device="cuda")
        y = bm.block_mv(A, x)
        scale = torch.einsum("bmk,bk->bm", A.double().abs(), x.double().abs())
        d = (y - bm.block_mv_plain(A, x)).abs().double()
        assert float((d / scale).max()) <= 1e-5


@pytest.mark.cuda
def test_scatter_plan_repeats_bitwise_on_card():
    """On the card: the deterministic scatter gives the same bits on every
    call, and index_add_'s sum to rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from navier_stokes_tpu_torch.ops.assembly import ScatterPlan

    gen = torch.Generator(device="cuda").manual_seed(3)
    index = torch.randint(0, 5000, (200000,), generator=gen, device="cuda")
    values = torch.randn(200000, generator=gen, device="cuda",
                         dtype=torch.float32)
    plan = ScatterPlan(index, 6000)
    first = plan(values)
    for _ in range(5):
        assert torch.equal(first, plan(values))
    want = values.double().new_zeros(6000).index_add_(0, index,
                                                      values.double())
    assert float((first.double() - want).abs().max()) <= 1e-5 * float(
        values.abs().sum()) / 5000
    assert bool((first[5000:] == 0).all())


@pytest.mark.cuda
def test_transient_step_repeats_bitwise_on_card():
    """On the card: two f32 SIMPLE steps of the 3D MCS model from the same
    state are bitwise equal (every scatter of the step is deterministic)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from navier_stokes_tpu_torch.flagship import build_model

    m = build_model(0.6, curved=False, dtype=torch.float32, device="cuda")
    step = m.make_step_fn(project_tol=1e-5)
    u1 = step(m.u)
    counts = dict(m.last_iterations)
    u2 = step(m.u)
    assert bool(torch.isfinite(u1).all())
    assert torch.equal(u1, u2)
    assert counts == m.last_iterations


# kernel 8 on the 2D models' tables: the condensed MCS operator (18 x 18 per
# triangle), the Taylor-Hood viscous table (12 x 12) and P2 mass (6 x 6),
# the MCS vertex stars (up to 64 dofs at maxh 0.05, 72 at 0.01)
TABLES_2D = [(762, 18, 0), (17002, 18, 1), (762, 12, 0), (762, 6, 2),
             (130, 64, 0), (57, 72, 3), (33, 41, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_local_matvec_2d_tables_on_card(dtype):
    """On the card: kernel 8 at the 2D models' table shapes, against its
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for ne, nb, off in TABLES_2D:
        fa = torch.randn(off + ne * nb * nb, generator=gen, device="cuda",
                         dtype=dt)
        fu = torch.randn(off + ne * nb, generator=gen, device="cuda",
                         dtype=dt)
        A, u = fa[off:].view(ne, nb, nb), fu[off:].view(ne, nb)
        y = batched_local_matvec(A, u)
        scale = torch.einsum("eij,ej->ei", A.double().abs(), u.double().abs())
        d = (y - batched_local_matvec_plain(A, u)).abs().double()
        assert float((d / scale).max()) <= TOL[dtype]


def _uin_2d(p):
    out = np.zeros((len(p), 2))
    out[:, 0] = 1.5 * 4 * p[:, 1] * (0.41 - p[:, 1]) / 0.41**2
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mcs", "taylor-hood"])
def test_2d_models_on_card_match_cpu(model):
    """On the card: the 2D MCS and Taylor-Hood models at maxh 0.3 -- the
    operators, the GS A-preconditioner (MCS) and one f64 step -- against
    the same models on the CPU (plain versions) within 1e-11, kernel 8
    launched; two steps from one state bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh
    from navier_stokes_tpu_torch.models import NavierStokes, NavierStokesMCS

    cls = NavierStokesMCS if model == "mcs" else NavierStokes
    kw = dict(nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
              uin=_uin_2d, timestep=1e-3, order=2)
    mesh = channel_with_cylinder_mesh(0.3)
    mc, mg = cls(mesh, device="cpu", **kw), cls(mesh, device="cuda", **kw)
    x = np.random.default_rng(5).standard_normal(mc.u.numel())
    xc, xg = torch.from_numpy(x), torch.from_numpy(x).cuda()
    ops = ["A", "mstar", "B"]
    if model == "mcs":
        ops.append("_preA_for")
    bm.reset_launches()
    for op in ops:
        fc, fg = getattr(mc, op), getattr(mg, op)
        if op == "_preA_for":
            fc, fg = fc(True), fg(True)
        want = fc(xc).numpy()
        got = fg(xg).cpu().numpy()
        assert np.linalg.norm(got - want) <= 1e-11 * np.linalg.norm(want)
    assert bm.LAUNCHES["batched_local_matvec_f64"] > 0
    mc.load_state(cheb_bounds=mg._mass_chebyshev().bounds)
    uc = mc.make_step_fn()(mc.u)
    step = mg.make_step_fn()
    u1, u2 = step(mg.u), step(mg.u)
    assert torch.equal(u1, u2)
    incr = np.linalg.norm(uc.numpy() - mc.u.numpy())
    assert np.linalg.norm(u1.cpu().numpy() - uc.numpy()) <= 1e-6 * incr


# the Stokes catalog's and the heat model's element tables, (ne, nb,
# offset): Crouzeix-Raviart (3), mini (4), P2 with a bubble (7), HDG BDM 2
# (21), the MCS triple of order 2 (39), heat at order 10 (66)
TABLES_CATALOG = [(4001, 3, 0), (3001, 3, 1), (410, 4, 2), (77, 7, 1),
                  (410, 21, 0), (57, 21, 3), (624, 39, 1), (200, 66, 0),
                  (33, 66, 1)]


@pytest.mark.cuda
def test_batched_local_matvec_catalog_tables_on_card():
    """On the card: kernel 8 in f64 at the Stokes catalog's and the heat
    model's widths (nb = 3 and 4: a few elements per CTA; nb = 66: rows
    528 bytes apart), against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(6)
    for ne, nb, off in TABLES_CATALOG:
        fa = torch.randn(off + ne * nb * nb, generator=gen, device="cuda",
                         dtype=torch.float64)
        fu = torch.randn(off + ne * nb, generator=gen, device="cuda",
                         dtype=torch.float64)
        A, u = fa[off:].view(ne, nb, nb), fu[off:].view(ne, nb)
        y = batched_local_matvec(A, u)
        scale = torch.einsum("eij,ej->ei", A.abs(), u.abs())
        d = (y - batched_local_matvec_plain(A, u)).abs()
        assert float((d / scale).max()) <= TOL["float64"]


def _catalog_ops(which, device):
    """(operators, an input size) of one model of the Stokes catalog or the
    heat model at a small size on ``device``."""
    from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh
    from navier_stokes_tpu_torch.models import discretizations as disc
    from navier_stokes_tpu_torch.models import stokes as st

    if which == "heat":
        from navier_stokes_tpu_torch.models.heat import HeatEquation

        m = HeatEquation(maxh=0.3, order=6, device=device)
        heat_apply, _ = m._heat_ops(0.002)
        return [m._apply_mass, m._apply_stiff, heat_apply], m.ndof
    mesh = channel_with_cylinder_mesh(0.3)
    if which == "mcs":
        from navier_stokes_tpu_torch.models.stokes_mcs import (
            assemble_mcs_stokes,
            mcs_discretization,
        )
        from navier_stokes_tpu_torch.ops.assembly import (
            ScatterPlan,
            apply_local_matrices,
        )

        V, S, Q = mcs_discretization(2)[0](
            mesh, velocity_dirichlet="wall|inlet|cyl",
            velocity_neumann="outlet")
        s = assemble_mcs_stokes(mesh, V, S, Q, st.default_volume_force,
                                st.default_inlet_profile())
        A = torch.as_tensor(s.A_loc, device=device)
        plan = ScatterPlan(torch.as_tensor(s.eldofs.astype(np.int64),
                                           device=device), s.ndofs)
        return [lambda x: apply_local_matrices(A, plan, s.ndofs, x,
                                               use_kernel=True)], s.ndofs
    if which == "mixed":
        s = st.build_stokes_system(mesh, disc.mini()[0],
                                   uin=st.default_inlet_profile(),
                                   device=device)
    else:
        from navier_stokes_tpu_torch.models.stokes_hybrid import (
            build_hybrid_stokes_system,
        )

        s = build_hybrid_stokes_system(mesh, disc.bdm_hybrid(2, 10)[0],
                                       uin=st.default_inlet_profile(),
                                       device=device)
    return [s.A, s.preA, s.B], s.f.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["mixed", "hdg", "mcs", "heat"])
def test_catalog_models_on_card_match_cpu(which):
    """On the card: the mixed (mini) and HDG (BDM 2, edgeblock) Stokes
    operators, the MCS operator and the heat model's mass, stiffness and
    M + dt K applies at maxh 0.3 against the same operators on the CPU
    (plain versions) within 1e-11, kernel 8 launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ops_c, n = _catalog_ops(which, "cpu")
    ops_g, _ = _catalog_ops(which, "cuda")
    x = np.random.default_rng(7).standard_normal(n)
    xc, xg = torch.from_numpy(x), torch.from_numpy(x).cuda()
    bm.reset_launches()
    for fc, fg in zip(ops_c, ops_g):
        want = fc(xc).numpy()
        got = fg(xg).cpu().numpy()
        assert np.linalg.norm(got - want) <= 1e-11 * np.linalg.norm(want)
    assert bm.LAUNCHES["batched_local_matvec_f64"] > 0


def _plates_mcs(device):
    """The 24-tet plates of tests/test_navier_stokes_mcs3d.py as a 3D MCS
    model on ``device`` (nu = 1e-3)."""
    from navier_stokes_tpu_torch.mesh.generators import (
        extrude_to_tets,
        rectangle_mesh,
    )
    from navier_stokes_tpu_torch.models import NavierStokesMCS

    mesh = extrude_to_tets(rectangle_mesh(0.5, 1.0, 1.0),
                           np.linspace(0, 0.5, 2))
    mesh.tag_boundary_by_predicate(
        "outlet", lambda p: np.abs(p[:, :, 0] - 1.0) < 1e-9)
    rest = np.setdiff1d(mesh.boundary_facets, mesh.boundary_tags["outlet"])
    mesh.boundary_tags["diri"] = rest.astype(np.int32)

    def uin(p):
        out = np.zeros((len(p), 3))
        out[:, 0] = p[:, 1] * (1.0 - p[:, 1])
        return out

    return NavierStokesMCS(mesh, nu=1e-3, inflow="diri", outflow="outlet",
                           wall="", uin=uin, timestep=1e-3, order=2,
                           device=device)


@pytest.mark.cuda
def test_elem_apply_multi_f64_route_on_card():
    """On the card: ``FaceBlockLayout.elem_apply_multi`` on float64 tables
    launches ``batched_local_matvec_f64`` once per table and matches the
    plain float64 products within 1e-13 of sum |c a u|; float32 tables
    still go through ``block_mv``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = _plates_mcs("cuda")
    lay = m.fb
    gen = torch.Generator(device="cuda").manual_seed(4)
    tabs = [torch.randn((lay.ne, lay.nb, lay.nb), generator=gen,
                        device="cuda", dtype=torch.float64)
            for _ in range(3)]
    u = torch.randn(m.n, generator=gen, device="cuda", dtype=torch.float64)
    c = torch.tensor(0.37, dtype=torch.float64, device="cuda")
    scales = (2.5, 1.0, c)
    bm.reset_launches()
    y = lay.elem_apply_multi([(tabs[0], 2.5), (tabs[1], None),
                              (tabs[2], c)])(u)
    assert bm.LAUNCHES["batched_local_matvec_f64"] == 3
    assert y.dtype == torch.float64
    ue = lay.gather_elem(*lay.split(u))
    ye = sum(s * torch.einsum("eij,ej->ei", A, ue)
             for A, s in zip(tabs, scales))
    ye_abs = sum(abs(float(s)) * torch.einsum("eij,ej->ei", A.abs(),
                                              ue.abs())
                 for A, s in zip(tabs, scales))
    want = lay.join(*lay.scatter_elem(ye))
    scale = lay.join(*lay.scatter_elem(ye_abs))
    assert float(((y - want).abs() / scale.clamp_min(1e-300)).max()) <= 1e-13
    bm.reset_launches()
    lay.elem_apply_multi([(tabs[0].float(), None)])(u.float())
    assert bm.LAUNCHES["block_mv"] == 1
    assert bm.LAUNCHES["batched_local_matvec_f64"] == 0


@pytest.mark.cuda
def test_reynolds_ensemble_on_card_matches_cpu():
    """On the card: the 3D MCS ensemble (``run_reynolds_ensemble_mcs``, 3
    viscosities, 2 steps) on the plates against the same on the CPU within
    1e-8 relative per member, kernel 8 (f64) launched; a member run alone
    equals its row bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from navier_stokes_tpu_torch.parallel import sweep

    mc, mg = _plates_mcs("cpu"), _plates_mcs("cuda")
    mc.load_state(cheb_bounds=mg._mass_chebyshev().bounds)
    nus = [1e-3, 3e-3, 1e-2]
    want = sweep.run_reynolds_ensemble_mcs(mc, nus, 2)
    bm.reset_launches()
    got = sweep.run_reynolds_ensemble_mcs(mg, nus, 2)
    assert bm.LAUNCHES["batched_local_matvec_f64"] > 0
    assert got.is_cuda and got.shape == (3, mg.n)
    for i in range(3):
        w, g = want[i].numpy(), got[i].cpu().numpy()
        assert np.linalg.norm(g - w) <= 1e-8 * np.linalg.norm(w), i
    alone = sweep.run_reynolds_ensemble_mcs(mg, nus[2:], 2)
    assert torch.equal(alone[0], got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [1, 2])
def test_sharded_fast_ops_on_card_match_cpu(ranks):
    """On the card: the face-sharded operators of ``parallel/faceshard.py``
    (the GS preconditioner; kernels 1, 2 and 8 on each rank's tables) on 1
    and 2 gloo ranks, all on ``cuda:0``, against one rank on the CPU in
    this process (the plain versions), in the global layout: f32 ops
    within 1e-5, f64 ops within 1e-12 of the largest entry, D equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from navier_stokes_tpu_torch.parallel import faceshard
    from navier_stokes_tpu_torch.parallel.sharding import launch, single_rank

    m = _plates_mcs("cpu")
    rng = np.random.default_rng(5)
    u = rng.standard_normal(m.n)
    p = rng.standard_normal(m.Q.ndof)

    def applied(n, run):
        host = faceshard.shard_fast_tables(m, n, gs=True)
        mQ, plan = host.common["mQ"], host.plan
        out = run(host, plan.vel_to_sharded(u), plan.p_to_sharded(p, mQ))
        return {k: (plan.p_to_global(v.numpy(), mQ) if k in ("B", "B64",
                                                            "preM")
                    else plan.vel_to_global(v.numpy()))
                for k, v in out.items()}

    def cpu(host, us, ps):
        mesh = single_rank("gloo", device="cpu")
        try:
            return faceshard.fast_ops_rank(mesh, host.rank(0), host.common,
                                           us, ps)
        finally:
            dist.destroy_process_group()

    def card(host, us, ps):
        return launch(faceshard.fast_ops_rank, ranks, host.common, us, ps,
                      backend="gloo", device="cuda:0", threads=1,
                      rank_args=[host.rank(s) for s in range(ranks)])

    want, got = applied(1, cpu), applied(ranks, card)
    assert np.array_equal(got["D"], want["D"])
    for name in ("A", "preA", "B", "BT", "preM", "A64", "B64", "BT64"):
        w, g = want[name].astype(np.float64), got[name].astype(np.float64)
        bound = 1e-12 if name.endswith("64") else 1e-5
        assert np.abs(g - w).max() <= bound * np.abs(w).max(), name

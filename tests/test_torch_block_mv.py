"""Parity of the port's block-matvec module (navier_stokes_tpu_torch/ops/
block_mv.py) with the JAX package's Pallas kernels (ops/pallas_mv.py).

On the CPU each wrapper takes its plain PyTorch version; the JAX kernels run
in interpret mode, as tests/test_pallas_mv.py runs them.  Inputs are made
with numpy from a seed and handed to both.  Tolerances:

* block_mv / block_mv2 / make_table_apply: |d| <= 1e-5 * sum_j |a_ij x_j|
  (f32 arithmetic, sums taken in another order);
* block_mv_comp: y_hi + y_lo within 1e-12 of sum_j |a_ij x_j| of the f64
  product, as the Pallas kernel is held (test_pallas_mv.py:125-151);
* the split-k versions: the same bounds against the JAX split-k launchers,
  fed through ``_pack_splitk`` (tests/test_pallas_mv.py:196-240); the
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


def _jax_splitk(A, k):
    """The JAX split-k operands of a table: _pack_splitk of pack_tiles."""
    subs, ng = _pack_splitk(pack_tiles(A, STILE), k)
    return subs, ng * k * STILE


def _soa(x, npad):
    out = np.zeros((x.shape[1], npad), x.dtype)
    out[:, :NE] = x.T
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
    stream_mv.block_mv_rows(A, x, 4)
    stream_mv.block_mv_mega(A, x, 2, 2)
    stream_mv.block_mv_ring(A, x, 2, 2)
    stream_mv.block_mv_soa(A.permute(1, 2, 0).contiguous(),
                           x.T.contiguous())
    assert set(bm.LAUNCHES) == {
        "block_mv", "block_mv2", "block_mv_comp", "block_mv_splitk",
        "block_mv2_splitk", "block_mv_comp_splitk", "block_mv_ds",
        "batched_local_matvec", "block_mv_rows", "block_mv_mega",
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
@pytest.mark.parametrize("k", [2, 3, 8])
def test_splitk_kernels_match_plain_on_card(k):
    """On the card: each split-k kernel against its plain version, and
    bitwise against its unsplit kernel on the same table."""
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
    torch.cuda.synchronize()

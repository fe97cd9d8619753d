"""Parity of the port's block-matvec module (navier_stokes_tpu_torch/ops/
block_mv.py) with the JAX package's Pallas kernels (ops/pallas_mv.py).

On the CPU each wrapper takes its plain PyTorch version; the JAX kernels run
in interpret mode, as tests/test_pallas_mv.py runs them.  Inputs are made
with numpy from a seed and handed to both.  Tolerances:

* block_mv / block_mv2 / make_table_apply: |d| <= 1e-5 * sum_j |a_ij x_j|
  (f32 arithmetic, sums taken in another order);
* block_mv_comp: y_hi + y_lo within 1e-12 of sum_j |a_ij x_j| of the f64
  product, as the Pallas kernel is held (test_pallas_mv.py:125-151).

The kernels themselves run only on the card: ``test_kernels_match_plain_on_
card`` carries the ``cuda`` marker and skips without a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.ops.pallas_mv import make_table_apply as jax_table_apply
from navier_stokes_tpu.ops.pallas_mv import (
    pack_tiles,
    tiled_bmv,
    tiled_bmv_comp,
    tiled_bmv_multi,
)
from navier_stokes_tpu_torch.ops import block_mv as bm

NE, NB, TILE = 37, 14, 16  # deliberately non-multiple ne, as test_pallas_mv


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
    assert bm.LAUNCHES == {"block_mv": 0, "block_mv2": 0, "block_mv_comp": 0}


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

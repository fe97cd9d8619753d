"""Parity of the port's element-local matvec and plain double-single
products with the JAX package's Pallas kernels.

* ``batched_local_matvec`` (``ops/local_mv.py``; on the CPU its plain
  version) against ``ops/pallas_kernels.batched_local_matvec`` in interpret
  mode, and ``apply_local_matrices`` against the JAX function with and
  without ``use_pallas``: float32 to rtol 2e-6 of sum_j |a_ij u_j| (f32 sums
  in another order), float64 to 1e-13 of it.
* ``block_mv_ds`` (kernel 3; on the CPU its plain version) against
  ``tiled_bmv_ds(interpret=True)`` on the data of
  tests/test_pallas_mv.py:93-122, square and rectangular: rtol 2e-6,
  atol 1e-5 as there, and the f64 sum of the three against the f64 product.

The comparison of each CUDA kernel with its plain version on the card
carries the ``cuda`` marker and skips without a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_tpu.ops import assembly as jax_asm
from navier_stokes_tpu.ops.pallas_kernels import (
    batched_local_matvec as jax_batched_local_matvec,
)
from navier_stokes_tpu.ops.pallas_mv import pack_tiles, tiled_bmv_ds
from navier_stokes_tpu_torch.ops import assembly as asm
from navier_stokes_tpu_torch.ops import block_mv as bm
from navier_stokes_tpu_torch.ops.local_mv import (
    batched_local_matvec,
    batched_local_matvec_plain,
)

NE, NB, TILE = 37, 14, 16  # tests/test_pallas_mv.py's shapes
TOL = {"float32": 2e-6, "float64": 1e-13}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(ne, nb, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((ne, nb, nb)).astype(dtype),
            rng.standard_normal((ne, nb)).astype(dtype))


def _row_scale(A, u):
    return np.einsum("eij,ej->ei", np.abs(A).astype(np.float64),
                     np.abs(u).astype(np.float64))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ne,nb", [(500, 6), (1000, 21), (77, 12), (300, 4),
                                   (40, 54)])
def test_batched_local_matvec_matches_jax_kernel(ne, nb, dtype):
    A, u = _blocks(ne, nb, dtype)
    want = np.asarray(jax_batched_local_matvec(
        jnp.asarray(A), jnp.asarray(u), interpret=True))
    for fn in (batched_local_matvec, batched_local_matvec_plain):
        got = fn(torch.from_numpy(A), torch.from_numpy(u))
        assert got.dtype == getattr(torch, dtype) and got.shape == (ne, nb)
        err = np.abs(got.numpy().astype(np.float64) - want)
        assert (err / _row_scale(A, u)).max() <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_local_matrices_matches_jax(use_kernel, dtype):
    rng = np.random.default_rng(1)
    ne, nb, ndof = 200, 10, 450
    A, _ = _blocks(ne, nb, dtype, seed=2)
    eldofs = np.stack([rng.choice(ndof, nb, replace=False)
                       for _ in range(ne)]).astype(np.int64)
    u = rng.standard_normal(ndof).astype(dtype)
    want = np.asarray(jax_asm.apply_local_matrices(
        jnp.asarray(A), jnp.asarray(eldofs), ndof, jnp.asarray(u),
        use_pallas=use_kernel), np.float64)
    got = asm.apply_local_matrices(
        torch.from_numpy(A), torch.from_numpy(eldofs), ndof,
        torch.from_numpy(u), use_kernel=use_kernel)
    assert got.dtype == getattr(torch, dtype)
    scale = np.zeros(ndof)
    np.add.at(scale, eldofs.ravel(), _row_scale(A, u[eldofs]).ravel())
    # up to ne/ndof*nb more terms per entry than one row: 10x the row bound
    err = np.abs(got.numpy() - want) / np.maximum(scale, 1e-300)
    assert err.max() <= 10 * TOL[dtype]
    np.testing.assert_array_equal(
        asm.gather(torch.from_numpy(u), torch.from_numpy(eldofs)).numpy(),
        u[eldofs])


def _pad_soa(x):
    ntile = -(-NE // TILE)
    out = np.zeros((x.shape[0], ntile * TILE), np.float32)
    out[:, :NE] = x
    return jnp.asarray(out)


@pytest.mark.parametrize("m", [NB, 6])
def test_block_mv_ds_matches_tiled_bmv_ds(m):
    A64 = np.random.default_rng(5).standard_normal((NE, m, NB))
    A_hi = A64.astype(np.float32)
    A_lo = (A64 - A_hi.astype(np.float64)).astype(np.float32)
    x64 = np.random.default_rng(6).standard_normal((NB, NE))
    x_hi = x64.astype(np.float32)
    x_lo = (x64 - x_hi.astype(np.float64)).astype(np.float32)
    want = tiled_bmv_ds(
        jnp.asarray(pack_tiles(A_hi, TILE)), jnp.asarray(pack_tiles(A_lo, TILE)),
        _pad_soa(x_hi), _pad_soa(x_lo), interpret=True)
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (A_hi, A_lo, x_hi.T, x_lo.T)]
    for fn in (bm.block_mv_ds, bm.block_mv_ds_plain):
        got = fn(*args)
        assert len(got) == 3
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == (NE, m)
            np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :NE].T,
                                       rtol=2e-6, atol=1e-5)
        ds = sum(g.double() for g in got).numpy()
        exact = np.einsum("eij,je->ei", A64, x64)
        np.testing.assert_allclose(ds, exact, rtol=0,
                                   atol=3e-6 * np.abs(exact).max())


@pytest.mark.parametrize("case", ["rect", "dtype", "mixed", "shape",
                                  "contiguous", "bf16"])
def test_batched_local_matvec_rejects_bad_inputs(case):
    A = torch.zeros((4, 5, 5))
    u = torch.zeros((4, 5))
    if case == "rect":
        A = torch.zeros((4, 3, 5))
    elif case == "dtype":
        A, u = A.to(torch.int32), u.to(torch.int32)
    elif case == "mixed":
        u = u.double()
    elif case == "shape":
        u = torch.zeros((4, 3))
    elif case == "contiguous":
        A = torch.ones((4, 5, 5)).transpose(1, 2)
    else:
        A, u = A.bfloat16(), u.bfloat16()
    with pytest.raises((TypeError, ValueError)):
        batched_local_matvec(A, u)


def test_block_mv_ds_rejects_bad_inputs():
    A = torch.zeros((4, 3, 5))
    x = torch.zeros((4, 5))
    with pytest.raises((TypeError, ValueError)):
        bm.block_mv_ds(A.double(), A, x, x)
    with pytest.raises((TypeError, ValueError)):
        bm.block_mv_ds(A, torch.zeros((4, 5, 5)), x, x)
    with pytest.raises((TypeError, ValueError)):
        bm.block_mv_ds(A, A, x, torch.zeros((4, 3)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_batched_local_matvec_kernel_matches_plain_on_card(dtype):
    """On the card: the kernel against its plain version at the transient
    step's block sizes (54 x 54 element blocks, 4 x 4 pressure blocks) and
    at sizes that leave a ragged last tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bm.reset_launches()
    for ne, nb in ((700, 54), (3001, 4), (77, 12), (1, 1), (5, 130)):
        A = torch.randn((ne, nb, nb), generator=gen, device="cuda", dtype=dt)
        u = torch.randn((ne, nb), generator=gen, device="cuda", dtype=dt)
        y = batched_local_matvec(A, u)
        scale = torch.einsum("eij,ej->ei", A.double().abs(), u.double().abs())
        d = (y - batched_local_matvec_plain(A, u)).abs().double()
        assert float((d / scale).max()) <= TOL[dtype]
    torch.cuda.synchronize()
    assert bm.LAUNCHES["batched_local_matvec"] == 5


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

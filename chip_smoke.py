#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``navier_stokes_tpu_torch``) on one GPU.

Drives the port's paths -- the initial Stokes solve of the 3D MCS channel
with cylinder at maxh=0.09, order 2, nu=1e-3, to a true f64 relative
residual of 1e-8, and the transient SIMPLE step on its float32 twin -- in
phases; any failed phase ends the run with a non-zero exit:

1. build: compile ``navier_stokes_tpu_torch/csrc/block_mv.cu``,
   ``local_mv.cu`` and ``stream_mv.cu`` with nvcc (sm_90a), all at once,
   and print the build seconds and the card;
2. setup: the mesh, then the MAIN PATH's configuration -- bench.py's
   default: order-3 curved cylinder (335 curved tets), symmetric multicolor
   block-GS skeleton preconditioner, bf16 extension and inverse tables,
   coarse damping target 1.6 -- and slice 1's straight additive
   configuration, seconds per phase and the GS color count;
3. kernel checks: every kernel wrapper on the main path's own device tables
   (and on an engineered cancellation case) against its plain PyTorch
   version on the same inputs, within the stated bounds, with its median
   time, its byte bound, the plain version's time and one PyTorch library
   call's time as a yardstick; the split-k kernels at k=2 and k=4 on the
   same tables, also BITWISE against their unsplit kernels; slice 1's
   tables are checked the same way.  A bound counts the bytes the function
   needs: the split-k kernels' on the unsplit tables (their zero pad is
   not loaded), the merged GS solve tables' on their real inverse blocks;
4. main path: launch counters set to 0, ``FlagshipSolve.full_solve`` of the
   curved GS configuration cold, counters read; every unsplit kernel must
   have launched; then a warm solve; the true-f64 residual of each must be
   <= 1.01e-8 in at most 460 inner iterations;
5. slice 1's path: the straight additive solve cold and warm, and phase 2
   alone polishing the warm solution to 1e-10;
6. split-k path: ``FlagshipSolve(m, split_k=2)`` on the curved model, one
   warm solve with the counters set to 0 just before it; each split-k
   kernel must launch, the residual must meet 1.01e-8 and the inner count
   must equal the split_k=1 solve's;
7. per-apply milliseconds (bench.py's probe_ops, CUDA events) of both
   configurations, with the GS parts: S_faces, one color step, coarse_gs;
8. profile: the device busy share of 100 phase-1 MINRES iterations
   (torch.profiler kernel time over unprofiled wall time) of each
   configuration and the kernels that take most of it;
9. ds: the residual of the converged solution through the plain 3 x f32
   double-single applies (``elem_apply_ds`` / ``rect_apply_ds``, one
   ``block_mv_ds`` launch each) beside the compensated one, both against
   the true f64 residual;
10. transient: the float32 twin of the curved model (same host tables),
    ``make_step_fn(project_tol=1e-5)`` from ``u = u_bc`` as bench.py's
    ``measure_transient``: one cold step with the launch counters set to 0
    just before it, then n warm steps (n calibrated to about 10 s, 3..200):
    steps/s, the M* and projection CG counts of every step, the
    projection's reduction of ||B u||, whether a step is bitwise
    repeatable, per-piece milliseconds and the device busy share; then 3
    float64 steps (project_tol=1e-9) from the flagship solution;
11. microbench: the two ported microbenchmark scripts
    (``navier_stokes_tpu_torch.scripts.microbench_dma`` on the
    7740 x 54 x 54 f32 table, ``microbench_apply2`` at maxh=0.09) with the
    launch counters set to 0 just before; each of the five table-stream
    wrappers must have launched;
12. amg: at maxh=0.04 (5,859 free velocity-P1 vertices, above the dense
    limit of 5,000, so both coarse solves are SA-AMG V-cycles):
    AMG-preconditioned CG on the P1 stiffness to 1e-8 in under 40
    iterations with the V-cycle symmetric to 1e-10, the curved GS flagship
    solve cold and warm to a true f64 residual <= 1.01e-8, and one cold and
    three warm float32 transient steps.

The kernel checks of phase 3 also cover ``batched_local_matvec`` (float32
and float64, on the mass, condensed-operator and pressure-block tables of
the transient step), ``block_mv_ds`` (on the split A, B, BT tables), and
every variant of the table-stream kernels (``block_mv_rows``, split-k at
k = 2, 4, 8, ``block_mv_mega``, ``block_mv_ring``, ``block_mv_soa``) on the
bench table, each also bitwise against ``block_mv``.

It prints the kernels' JSON line and the card's name and power limit on
lines before the last, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
MAXH, ORDER, NU, TOL = 0.09, 2, 1e-3, 1e-8
MAX_INNER = 460  # the bench's iteration budget at this size
SPLIT_K = 2  # the split-k path's k; kernels are also checked at 4
TILE, TILE_COMP = 256, 128  # split-k tiles (bench.py's NSTPU_TILE, comp B)
BENCH_NBLK, BENCH_NB = 7740, 54  # the microbenchmarks' table (maxh=0.09)
AMG_MAXH = 0.04  # 5,859 free velocity-P1 vertices: above the dense limit
SRC = "navier_stokes_tpu_torch/csrc/block_mv.cu"
SRC_LOCAL = "navier_stokes_tpu_torch/csrc/local_mv.cu"
SRC_STREAM = "navier_stokes_tpu_torch/csrc/stream_mv.cu"
DMA = "scripts/microbench_dma.py"
APPLY2 = "scripts/microbench_apply2.py"
PALLAS = "navier_stokes_tpu/ops/pallas_mv.py"
PALLAS_LOCAL = "navier_stokes_tpu/ops/pallas_kernels.py"
F64_FLOPS_PER_S = 34e12  # H100 SXM f64 outside the tensor cores
PROJECT_TOL32, PROJECT_TOL64, MSTAR_TOL = 1e-5, 1e-9, 1e-4


def log(*a):
    print(*a, flush=True)


class Fail(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


# -- kernel checks --------------------------------------------------------------


class KernelReport:
    """Sums one kernel's checks over the shapes of the main path."""

    def __init__(self, name, replaces, source=SRC):
        self.name, self.replaces, self.source = name, replaces, source
        self.ms = self.plain_ms = self.library_ms = 0.0
        self.bytes = self.flops = self.n = 0
        self.max_abs_err = 0.0

    def add(self, ms, plain_ms, library_ms, nbytes, flops, err):
        self.n += 1
        self.ms += ms
        self.plain_ms += plain_ms
        self.library_ms += library_ms
        self.bytes += nbytes
        self.flops += flops
        self.max_abs_err = max(self.max_abs_err, err)

    def bound(self):
        tb = self.bytes / HBM_BYTES_PER_S
        tf = self.flops / F32_FLOPS_PER_S
        return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")

    def entry(self, launches):
        bound_ms, bound_by = self.bound()
        return {
            "name": self.name, "route": "cuda", "source": self.source,
            "replaces": self.replaces, "launches": int(launches),
            "max_abs_err": float(self.max_abs_err), "ms": self.ms,
            "plain_ms": self.plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": self.library_ms,
        }


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def add(rep, *a):
    if rep is not None:
        rep.add(*a)


def check_block_mv(torch, bm, timer, rep, label, A, gen, real_bytes=None):
    """``real_bytes``: the table bytes the function needs, where the table
    holds zero padding (the merged GS solve tables: every block padded to
    the color's largest); the bound counts those, not the padded table."""
    nblk, m, k = A.shape
    x = torch.randn((nblk, k), generator=gen, device="cuda")
    y = bm.block_mv(A, x)
    y_ref = bm.block_mv_plain(A, x)
    torch.cuda.synchronize()
    A32 = A.to(torch.float32)
    scale = torch.einsum("bmk,bk->bm", A32.abs().double(), x.abs().double())
    err = (y - y_ref).abs()
    worst = float((err.double() / scale.clamp_min(1e-300)).max())
    check(bool(torch.isfinite(y).all()), f"block_mv {label}: non-finite")
    check(worst <= 1e-5, f"block_mv {label}: {worst:.2e} > 1e-5 of sum|a x|")
    xb = x[:, :, None]
    ms = timer(lambda: bm.block_mv(A, x))
    plain_ms = timer(lambda: bm.block_mv_plain(A, x))
    lib_ms = timer(lambda: torch.bmm(A32, xb))  # f32 copy: a yardstick
    nb = nbytes(A, x, y)
    bound = f"bound {nb / HBM_BYTES_PER_S * 1e3:.4f}"
    flops = 2 * A.numel()
    if real_bytes is not None:
        real_nb = real_bytes + nbytes(x, y)
        bound += (f" ({nb / 1e6:.1f} MB); real blocks "
                  f"{real_bytes / 1e6:.1f} MB, bound "
                  f"{real_nb / HBM_BYTES_PER_S * 1e3:.4f}")
        flops = 2 * real_bytes // A.element_size()
        nb = real_nb
    add(rep, ms, plain_ms, lib_ms, nb, flops, float(err.max()))
    log(f"  block_mv {label} {tuple(A.shape)} {str(A.dtype)[6:]}: "
        f"max|d|={float(err.max()):.3e} rel={worst:.2e} | kernel {ms:.4f} ms"
        f", plain {plain_ms:.4f}, bmm {lib_ms:.4f}, {bound}")


def check_block_mv2(torch, bm, timer, rep, label, A_hi, A_lo, gen):
    nblk, m, k = A_hi.shape
    x = torch.randn((nblk, k), generator=gen, device="cuda")
    y = bm.block_mv2(A_hi, A_lo, x)
    y_ref = bm.block_mv2_plain(A_hi, A_lo, x)
    torch.cuda.synchronize()
    scale = torch.einsum("bmk,bk->bm", (A_hi.double() + A_lo.double()).abs(),
                         x.abs().double())
    err = (y - y_ref).abs()
    worst = float((err.double() / scale.clamp_min(1e-300)).max())
    check(bool(torch.isfinite(y).all()), f"block_mv2 {label}: non-finite")
    check(worst <= 1e-5, f"block_mv2 {label}: {worst:.2e} > 1e-5")
    Acat = torch.cat([A_hi, A_lo], dim=2)
    xcat = torch.cat([x, x], dim=1)[:, :, None]
    ms = timer(lambda: bm.block_mv2(A_hi, A_lo, x))
    plain_ms = timer(lambda: bm.block_mv2_plain(A_hi, A_lo, x))
    lib_ms = timer(lambda: torch.bmm(Acat, xcat))
    add(rep, ms, plain_ms, lib_ms, nbytes(A_hi, A_lo, x, y),
        4 * A_hi.numel(), float(err.max()))
    log(f"  block_mv2 {label} {tuple(A_hi.shape)}: max|d|="
        f"{float(err.max()):.3e} rel={worst:.2e} | kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f}, bmm {lib_ms:.4f}, bound "
        f"{nbytes(A_hi, A_lo, x, y) / HBM_BYTES_PER_S * 1e3:.4f}")


def comp_accuracy(torch, label, A_hi, A_lo, x_hi, x_lo, got, ref):
    """y_hi + y_lo (kernel ``got`` and plain ``ref``) against the f64
    product of the same operands: within 1e-12 of sum_j |a_ij x_j|."""
    A64 = A_hi.double() + A_lo.double()
    xs = x_hi.double() + x_lo.double()
    want = torch.einsum("bmk,bk->bm", A64, xs)
    scale = torch.einsum("bmk,bk->bm", A64.abs(), xs.abs()).clamp_min(1e-300)
    g = got[0].double() + got[1].double()
    r = ref[0].double() + ref[1].double()
    worst = float(((g - want).abs() / scale).max())
    plain_rel = float(((r - want).abs() / scale).max())
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite")
    check(worst <= 1e-12, f"{label}: {worst:.2e} > 1e-12 of the row scale")
    check(plain_rel <= 1e-12, f"{label} plain: {plain_rel:.2e}")
    return float((g - r).abs().max()), worst, plain_rel


def check_comp(torch, bm, timer, rep, label, A_hi, A_lo, x64, timed=True):
    """Compensated kernel vs its plain version, and y_hi + y_lo vs the f64
    product of the same operands within 1e-12 of sum_j |a_ij x_j|."""
    x_hi, x_lo = bm.split_f64(x64)
    got = bm.block_mv_comp(A_hi, A_lo, x_hi, x_lo)
    ref = bm.block_mv_comp_plain(A_hi, A_lo, x_hi, x_lo)
    torch.cuda.synchronize()
    err, worst, plain_rel = comp_accuracy(
        torch, f"block_mv_comp {label}", A_hi, A_lo, x_hi, x_lo, got, ref)
    line = (f"  block_mv_comp {label} {tuple(A_hi.shape)}: max|d plain|="
            f"{err:.3e}, row-rel vs f64 {worst:.2e} (plain {plain_rel:.2e})")
    if timed:
        A64 = A_hi.double() + A_lo.double()
        xb = (x_hi.double() + x_lo.double())[:, :, None]
        ms = timer(lambda: bm.block_mv_comp(A_hi, A_lo, x_hi, x_lo))
        plain_ms = timer(lambda: bm.block_mv_comp_plain(A_hi, A_lo, x_hi,
                                                        x_lo))
        lib_ms = timer(lambda: torch.bmm(A64, xb))  # f64 copy: a yardstick
        nb = nbytes(A_hi, A_lo, x_hi, x_lo, *got)
        add(rep, ms, plain_ms, lib_ms, nb, 15 * A_hi.numel(), err)
        line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f}, f64 bmm "
                 f"{lib_ms:.4f}, bound {nb / HBM_BYTES_PER_S * 1e3:.4f}")
    log(line)


def check_splitk(torch, bm, timer, rep, label, kind, tabs, k, tile, gen,
                 x64=None, timed=True):
    """One split-k kernel on the sub-tables of ``tabs`` (one table, or the
    hi/lo pair) against its plain version within the stated bound, and
    BITWISE against the unsplit kernel on the same table.  The bound, the
    operation count and the ``bmm`` yardstick are those of the function on
    the unsplit tables: the zero pad of the sub-tables is not its work (the
    kernel does not load it)."""
    nblk, m, kk = tabs[0].shape
    packs = [bm.pack_splitk(t, k, tile) for t in tabs]
    if kind == "comp":
        x64 = (torch.randn((nblk, kk), generator=gen, device="cuda",
                           dtype=torch.float64) if x64 is None else x64)
        xs = bm.split_f64(x64)
        args = (packs[0], packs[1], *xs, tile)
        fn, plain = bm.block_mv_comp_splitk, bm.block_mv_comp_splitk_plain
        got, ref = fn(*args), plain(*args)
        unsplit = bm.block_mv_comp(tabs[0], tabs[1], *xs)
        torch.cuda.synchronize()
        err, worst, _ = comp_accuracy(torch, f"{label} k={k}", *tabs, *xs,
                                      got, ref)
        same = all(torch.equal(a, b) for a, b in zip(got, unsplit))
        A64 = tabs[0].double() + tabs[1].double()
        xb = (xs[0].double() + xs[1].double())[:, :, None]
        lib = lambda: torch.bmm(A64, xb)  # noqa: E731
        nb = nbytes(*tabs, *xs, *got)
        flops = 15 * tabs[0].numel()
    else:
        x = torch.randn((nblk, kk), generator=gen, device="cuda")
        if kind == "mv":
            args = (packs[0], x, tile)
            fn, plain = bm.block_mv_splitk, bm.block_mv_splitk_plain
            unsplit = bm.block_mv(tabs[0], x)
            Acat = tabs[0].to(torch.float32)
            xb = x[:, :, None]
            flops = 2 * tabs[0].numel()
        else:
            args = (packs[0], packs[1], x, tile)
            fn, plain = bm.block_mv2_splitk, bm.block_mv2_splitk_plain
            unsplit = bm.block_mv2(tabs[0], tabs[1], x)
            Acat = torch.cat(tabs, dim=2)
            xb = torch.cat([x, x], dim=1)[:, :, None]
            flops = 4 * tabs[0].numel()
        got, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        scale = torch.einsum("bmk,bk->bm", sum(t.double().abs() for t in tabs),
                             x.abs().double()).clamp_min(1e-300)
        d = (got - ref).abs()
        worst = float((d.double() / scale).max())
        err = float(d.max())
        check(bool(torch.isfinite(got).all()), f"{label} k={k}: non-finite")
        check(worst <= 1e-5, f"{label} k={k}: {worst:.2e} > 1e-5 of "
              "sum|a x|")
        same = torch.equal(got, unsplit)
        lib = lambda: torch.bmm(Acat, xb)  # noqa: E731
        nb = nbytes(*tabs, x, got)
    check(same, f"{label} k={k}: not bitwise equal to the unsplit kernel")
    line = (f"  {fn.__name__} {label} k={k} {tuple(tabs[0].shape)} "
            f"{str(tabs[0].dtype)[6:]}: max|d plain|={err:.3e} "
            f"rel={worst:.2e}, bitwise = unsplit")
    if timed:
        ms = timer(lambda: fn(*args))
        plain_ms = timer(lambda: plain(*args))
        lib_ms = timer(lib)
        add(rep, ms, plain_ms, lib_ms, nb, flops, err)
        line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f}, bmm "
                 f"{lib_ms:.4f}, bound {nb / HBM_BYTES_PER_S * 1e3:.4f}")
    log(line)


def check_local_mv(torch, lm, timer, rep, label, A, gen):
    """``batched_local_matvec`` on the (ne, nb, nb) table ``A`` (f32 or
    f64) against its plain version: within 2e-6 (f32) or 1e-13 (f64) of
    sum_j |a_ij u_j|.  The yardstick is one ``torch.bmm``."""
    ne, nb, _ = A.shape
    f64 = A.dtype == torch.float64
    u = torch.randn((ne, nb), generator=gen, device="cuda", dtype=A.dtype)
    y = lm.batched_local_matvec(A, u)
    y_ref = lm.batched_local_matvec_plain(A, u)
    torch.cuda.synchronize()
    scale = torch.einsum("eij,ej->ei", A.double().abs(), u.double().abs())
    err = (y - y_ref).abs()
    worst = float((err.double() / scale.clamp_min(1e-300)).max())
    tol = 1e-13 if f64 else 2e-6
    name = f"batched_local_matvec {label} {tuple(A.shape)} {str(A.dtype)[6:]}"
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite")
    check(worst <= tol, f"{name}: {worst:.2e} > {tol:.0e} of sum|a u|")
    ub = u[:, :, None]
    ms = timer(lambda: lm.batched_local_matvec(A, u))
    plain_ms = timer(lambda: lm.batched_local_matvec_plain(A, u))
    lib_ms = timer(lambda: torch.bmm(A, ub))
    nb_ = nbytes(A, u, y)
    rate = F64_FLOPS_PER_S if f64 else F32_FLOPS_PER_S
    add(rep, ms, plain_ms, lib_ms, nb_, 2 * A.numel(), float(err.max()))
    log(f"  {name}: max|d|={float(err.max()):.3e} rel={worst:.2e} | kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f}, bmm {lib_ms:.4f}, bound "
        f"{nb_ / HBM_BYTES_PER_S * 1e3:.4f} (bytes; operations "
        f"{2 * A.numel() / rate * 1e3:.4f})")


def check_ds(torch, bm, timer, rep, label, A_hi, A_lo, gen):
    """``block_mv_ds`` against its plain version, each of the three
    products within 2e-6 of sum_j |a_ij x_j|, and their f64 sum against the
    f64 product of the same operands (printed: plain f32 accumulation).
    The yardstick is one f32 ``torch.bmm`` of the stacked tables with
    [x_hi, x_lo] (it also computes A_lo x_lo)."""
    nblk, m, k = A_hi.shape
    x64 = torch.randn((nblk, k), generator=gen, device="cuda",
                      dtype=torch.float64)
    x_hi, x_lo = bm.split_f64(x64)
    got = bm.block_mv_ds(A_hi, A_lo, x_hi, x_lo)
    ref = bm.block_mv_ds_plain(A_hi, A_lo, x_hi, x_lo)
    torch.cuda.synchronize()
    A64 = A_hi.double() + A_lo.double()
    scale = torch.einsum("bmk,bk->bm", A64.abs(), x64.abs()).clamp_min(1e-300)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    worst = max(float(((g - r).abs().double() / scale).max())
                for g, r in zip(got, ref))
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"block_mv_ds {label}: non-finite")
    check(worst <= 2e-6, f"block_mv_ds {label}: {worst:.2e} > 2e-6 of "
          "sum|a x|")
    ds = sum(g.double() for g in got)
    ds_rel = float(((ds - torch.einsum("bmk,bk->bm", A64, x64)).abs()
                    / scale).max())
    Acat = torch.cat([A_hi, A_lo], dim=1)
    xcat = torch.stack([x_hi, x_lo], dim=2)
    ms = timer(lambda: bm.block_mv_ds(A_hi, A_lo, x_hi, x_lo))
    plain_ms = timer(lambda: bm.block_mv_ds_plain(A_hi, A_lo, x_hi, x_lo))
    lib_ms = timer(lambda: torch.bmm(Acat, xcat))
    nb = nbytes(A_hi, A_lo, x_hi, x_lo, *got)
    add(rep, ms, plain_ms, lib_ms, nb, 6 * A_hi.numel(), err)
    log(f"  block_mv_ds {label} {tuple(A_hi.shape)}: max|d plain|={err:.3e} "
        f"rel={worst:.2e}, f64 sum vs f64 product row-rel {ds_rel:.2e} | "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f}, bmm {lib_ms:.4f}, bound "
        f"{nb / HBM_BYTES_PER_S * 1e3:.4f}")


def cancellation_case(torch, nblk, nb, seed):
    """tests/test_pallas_mv.py's engineered ~1e5 row cancellation."""
    import numpy as np

    rng = np.random.default_rng(seed)
    A64 = rng.standard_normal((nblk, nb, nb))
    x64 = rng.standard_normal((nblk, nb))
    A64[:, :, 0] *= 1e5
    A64[:, :, 1] = -A64[:, :, 0] * (x64[:, 0] / x64[:, 1])[:, None]
    A = torch.as_tensor(A64, device="cuda")
    hi = A.to(torch.float32)
    lo = (A - hi.double()).to(torch.float32)
    return hi.contiguous(), lo.contiguous(), torch.as_tensor(x64,
                                                             device="cuda")


def solve_table_real_bytes(parts):
    """Per merged GS solve table: the bytes of its real inverse blocks
    (block b of a color holds nf_b faces of nfb rows each: (nf_b*nfb)^2
    entries; the rest of its (12 fsz_max)^2 is zero padding)."""
    out = {}
    nfb = parts["layout"].nfb
    for c, g in enumerate(parts.get("groups", [])):
        nsel = g.faces.shape[0] - 1
        nf = (g.rows < nsel).sum(dim=1)  # real faces per block (pad: 0)
        A = g.solve.table
        out[f"GS color {c} solve"] = int(((nf * nfb) ** 2).sum()) \
            * A.element_size()
    return out


def profile_minres(torch, solver, label, steps=100):
    """Device busy share of phase-1 MINRES (:func:`profile_device`)."""
    from navier_stokes_tpu_torch.solvers.minres import minres

    f32 = torch.float32
    rhs = ((solver.D * solver.f_mod).to(f32), solver.g_mod.to(f32))

    def run():
        minres(solver.K32, rhs, pre=solver.pre32, maxsteps=steps, tol=1e-30,
               abs_test=False)
        torch.cuda.synchronize()

    profile_device(torch, run, label, f"{steps} MINRES iterations")


def profile_device(torch, run, label, what):
    """Device busy share of ``run`` (which ends in a synchronize): the
    card's kernel time under torch.profiler over the wall time of the same
    call run unprofiled, and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    rows = []  # kernels only: an operator's row repeats its kernels' time
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    dev_ms = sum(r[0] for r in rows)
    if dev_ms == 0:
        log(f"[profile {label}] {what}: wall "
            f"{wall_ms:.2f} ms; device time not measured (the profiler saw "
            "no device time)")
        return
    log(f"[profile {label}] {what}: wall {wall_ms:.2f} ms "
        f"unprofiled, device kernel time {dev_ms:.2f} ms, device busy "
        f"{dev_ms / wall_ms:.3f} (idle {1 - dev_ms / wall_ms:.3f})")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        log(f"[profile {label}]   {ms:9.3f} ms  x{count:<6d} {key[:70]}")


def solve_and_check(torch, bm, solver, label, max_inner=None):
    """One full_solve with the launch counters set to 0 just before it;
    returns (result, launches)."""
    bm.reset_launches()
    res = solver.full_solve()
    launches = dict(bm.LAUNCHES)
    for line in res.log:
        log(f"  {label} {line}")
    log(f"[solve] {label}: inner={res.inner}, {res.seconds:.3f} s, "
        f"{res.inner / res.seconds:.1f} inner its/s, ds rel {res.rel:.3e}, "
        f"true f64 rel {res.true_rel:.3e}, launches {launches}")
    m = solver.m
    u, p = res.x
    check(tuple(u.shape) == (m.n,) and tuple(p.shape) == (m.Q.ndof,),
          f"{label}: solution has the wrong shape")
    check(bool(torch.isfinite(u).all() and torch.isfinite(p).all()),
          f"{label}: solution is not finite")
    check(res.true_rel <= 1.01 * TOL,
          f"{label}: true f64 residual {res.true_rel:.3e} > {1.01 * TOL:.3e}")
    if max_inner is not None:
        check(res.inner <= max_inner,
              f"{label}: {res.inner} inner iterations > {max_inner}")
    return res, launches


def apply_probes(torch, label, solver):
    from navier_stokes_tpu_torch.utils.timers import per_apply_ms

    f32, f64 = torch.float32, torch.float64
    m = solver.m
    o32, ods = solver.ops32, solver.ops_ds
    parts = o32["preA"].parts
    lay = parts["layout"]
    u32 = torch.ones(m.n, dtype=f32, device="cuda")
    p32 = torch.ones(m.Q.ndof, dtype=f32, device="cuda")
    u64 = torch.ones(m.n, dtype=f64, device="cuda")
    p64 = torch.ones(m.Q.ndof, dtype=f64, device="cuda")
    xF = torch.ones((lay.nface, lay.nfb), dtype=f32, device="cuda")
    probes = [
        ("A32 split", o32["A"], u32),
        ("BT32*B32", lambda v: o32["BT"](o32["B"](v)), u32),
        ("preA32", o32["preA"], u32),
        ("preM32", o32["preM"], p32),
        ("A_ds", ods["A"], u64),
        ("BT_ds*B_ds", lambda v: ods["BT"](ods["B"](v)), u64),
        ("residual_pass", lambda v: solver.residual_pass(v, p64), u64),
        ("A64 (f64 torch)", m.A, u64),
        ("preA32.pre_skel", parts["pre_skel"], xF),
        ("preA32.coarse", parts["coarse_only"], xF),
    ]
    if "groups" in parts:
        sm, g = parts["smoother"], parts["groups"][0]
        xP = torch.ones((lay.nface + 1, lay.nfb), dtype=f32, device="cuda")
        probes += [
            ("preA32.S_faces", parts["S_faces"], xF),
            ("preA32.GS color step", lambda v: sm.solve_color_rows(g, v, v),
             xP),
        ]
    else:
        probes.append(("preA32.smooth", parts["smooth_only"], xF))
    for name, fn, x in probes:
        log(f"[apply {label}] {name:22s} {per_apply_ms(fn, x):.4f} ms")


def ds_phase(torch, bm, solver, res):
    """The residual of the converged solution ``res`` through the plain
    3 x f32 double-single applies, beside the compensated one, both held
    against the true f64 residual (plain f64 torch operators).  Returns the
    ``block_mv_ds`` launches of the phase."""
    m, ods = solver.m, solver.ops_ds
    _A3 = m.fb.elem_apply_ds(*ods["A"].tables)
    _B3, _BT3 = m.fb.rect_apply_ds(*ods["B"].tables, m.Q.element_dofs)
    free = m.free

    def A3(u):  # masked as the compensated operators are
        uf = torch.where(free, u, 0.0)
        return torch.where(free, _A3(uf), u)

    def B3(u):
        return _B3(torch.where(free, u, 0.0))

    def BT3(p):
        return torch.where(free, _BT3(p), 0.0)

    x0, x1 = res.x
    Dinv = 1.0 / solver.D
    bm.reset_launches()
    r_ds = (solver.f_mod - Dinv * A3(Dinv * x0) - Dinv * BT3(x1),
            solver.g_mod - B3(Dinv * x0))
    torch.cuda.synchronize()
    launches = bm.LAUNCHES["block_mv_ds"]
    r_comp = solver.residual_pass(x0, x1)
    r64 = solver.residual64(x0, x1)

    def dist(r):
        return solver.true_rel(r[0] - r64[0], r[1] - r64[1])

    rel_ds, rel_comp = solver.true_rel(*r_ds), solver.true_rel(*r_comp)
    e_ds, e_comp = dist(r_ds), dist(r_comp)
    log(f"[ds] residual of the converged solution: true f64 "
        f"{solver.true_rel(*r64):.3e}; 3 x f32 double-single {rel_ds:.3e} "
        f"(off the f64 residual vector by {e_ds:.3e} of |rhs|); compensated "
        f"{rel_comp:.3e} (off by {e_comp:.3e}); {launches} block_mv_ds "
        "launches")
    check(all(bool(torch.isfinite(r).all()) for r in r_ds),
          "[ds] residual is not finite")
    check(launches == 3, f"[ds] {launches} block_mv_ds launches, expected 3")
    check(e_ds >= e_comp, f"[ds] the plain double-single residual "
          f"({e_ds:.3e}) is closer to f64 than the compensated ({e_comp:.3e})")
    return launches


def host_ms(torch, fn, reps=3):
    """Median host-clock milliseconds of ``fn()`` ending in a synchronize
    (pieces with their own host reads, as the CG solves)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def projection_check(torch, m, u, label):
    """What the f32 projection does to ||B u|| on the right-hand side of one
    step from ``u``: it must reduce it by 1e-4.  Returns the step's masked
    right-hand side, M*^-1 of it and the projection's pressure."""
    temp = torch.where(m.free, m.convection(u) + m.f - m._A_raw_step(u), 0.0)
    v = m._inv_mstar(temp, precision=MSTAR_TOL)
    w, p = m._project_velocity(v, tol=PROJECT_TOL32)
    bv, bw = (float(torch.linalg.norm(m.B_raw(t).double())) for t in (v, w))
    log(f"{label} projection: ||B v|| {bv:.3e} -> ||B P v|| {bw:.3e} (ratio "
        f"{bw / bv:.3e})")
    check(bw <= 1e-4 * bv, f"{label} the projection reduced ||B u|| only by "
          f"{bw / bv:.3e}")
    return temp, v, p


def transient_phase(torch, bm, m, step, m64, u64_start):
    """bench.py's second metric on the port: the f32 SIMPLE step ``step`` of
    the stepping model ``m``, then 3 f64 steps of ``m64`` from the flagship
    solution.  Returns the launch counts of one (the cold) f32 step."""
    from navier_stokes_tpu_torch.flagship import transient_steps
    from navier_stokes_tpu_torch.solvers.cg import cg
    from navier_stokes_tpu_torch.utils.timers import per_apply_ms

    def norm(v):
        return float(torch.linalg.norm(v.double()))

    # one cold step from u = u_bc, counters at 0 just before it
    u0 = m.u
    bm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = step(u0)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    launches = dict(bm.LAUNCHES)
    counts = [dict(m.last_iterations)]
    check(bool(torch.isfinite(u).all()), "[transient] cold step not finite")
    log(f"[transient] f32 cold step {t_cold:.3f} s, M* CG "
        f"{counts[0]['mstar']}, projection CG {counts[0]['project']}, "
        f"launches {launches}")
    check(launches["batched_local_matvec"] > 0,
          "batched_local_matvec never launched in the step")
    # is a step bitwise repeatable?  (index_add_ uses float atomics)
    u_again = step(u0)
    same = torch.equal(u, u_again)
    log(f"[transient] the same step again: bitwise "
        f"{'equal' if same else 'different'}, max |d| "
        f"{float((u - u_again).abs().max()):.3e} (max |u1 - u0| "
        f"{float((u - u0).abs().max()):.3e}), CG counts "
        f"{dict(m.last_iterations)}")

    # warm steps, calibrated as bench.py:228-240
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = step(u)
    torch.cuda.synchronize()
    dt1 = time.perf_counter() - t0
    counts.append(dict(m.last_iterations))
    n_steps = max(3, min(200, int(10.0 / max(dt1, 1e-3))))
    t0 = time.perf_counter()
    for _ in range(n_steps):
        u = step(u)
        counts.append(dict(m.last_iterations))
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    check(bool(torch.isfinite(u).all()), "[transient] the steps blew up")
    ms_, pr_ = ([c[k] for c in counts] for k in ("mstar", "project"))
    log(f"[transient] f32: {n_steps} warm steps in {t_warm:.3f} s "
        f"({n_steps / t_warm:.3f} steps/s, {t_warm / n_steps * 1e3:.1f} "
        f"ms/step; calibration step {dt1:.3f} s); M* CG per step "
        f"{min(ms_)}..{max(ms_)} (first {ms_[:4]}, last {ms_[-1]}), "
        f"projection CG {min(pr_)}..{max(pr_)} (first {pr_[:4]}, last "
        f"{pr_[-1]}); max |u| {float(u.abs().max()):.4f}")
    check(max(pr_) < 2000 and max(ms_) < 2000, "a CG ran into maxsteps")

    # the pieces of one step, and what the projection does to ||B u||
    conv, A_step = m.convection, m._A_raw_step
    Minv, pre2 = m._mass_chebyshev(), m._pre_proj_twolevel()
    temp, v, p = projection_check(torch, m, u, "[transient]")
    log(f"[transient] ||B u|| after the steps {norm(m.B_raw(u)):.3e}, of "
        f"u_bc {norm(m.B_raw(u0)):.3e}")
    rhs_p = m.B_raw(v)

    def S(q):
        return m.B(Minv(m.BT(q)))

    pieces = [
        ("conv", lambda: conv(u)),
        ("A_raw (kernel route)", lambda: A_step(u)),
        ("mass_raw", lambda: m._mass_raw(u)),
        ("mstar apply", lambda: m.mstar(u)),
        ("Minv (Chebyshev 16)", lambda: Minv(temp)),
        ("B_raw", lambda: m.B_raw(u)),
        ("BT", lambda: m.BT(p)),
        ("S apply (B Minv BT)", lambda: S(p)),
        ("twolevel pre", lambda: pre2(p)),
        ("twolevel block", lambda: pre2.block(p)),
    ]
    for name, fn in pieces:
        log(f"[piece f32] {name:22s} "
            f"{per_apply_ms(lambda _x: fn(), None, k=10):.4f} ms")
    for name, fn in (
            ("inv_mstar (CG 1e-4)", lambda: m._inv_mstar(temp, MSTAR_TOL)),
            ("project (CG 1e-5)", lambda: m._project_velocity(
                v, tol=PROJECT_TOL32)),
            ("projection CG alone", lambda: cg(S, rhs_p, pre=pre2,
                                               tol=PROJECT_TOL32,
                                               maxsteps=2000)),
            ("whole step", lambda: step(u))):
        log(f"[piece f32] {name:22s} {host_ms(torch, fn):.2f} ms (host "
            "clock, median of 3)")

    def run3():
        x = u
        for _ in range(3):
            x = step(x)
        torch.cuda.synchronize()

    profile_device(torch, run3, "transient f32", "3 steps")

    # 3 f64 steps from the flagship solution
    t0 = time.perf_counter()
    step64 = m64.make_step_fn(project_tol=PROJECT_TOL64, mstar_tol=MSTAR_TOL)
    torch.cuda.synchronize()
    log(f"[setup] transient f64: step setup {time.perf_counter() - t0:.1f} "
        "s: " + ", ".join(f"{k} {v:.1f} s"
                          for k, v in m64.setup_seconds.items()))
    del step64
    bm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u64, counts64 = transient_steps(m64, 3, project_tol=PROJECT_TOL64,
                                    mstar_tol=MSTAR_TOL, u=u64_start)
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    check(bool(torch.isfinite(u64).all()), "[transient] f64 steps blew up")
    check(u64.dtype == torch.float64, "[transient] f64 steps lost precision")
    log(f"[transient] f64: 3 steps from the flagship solution in {t64:.3f} s "
        f"({t64 / 3 * 1e3:.1f} ms/step, the first one cold), CG counts "
        f"{counts64}, ||B u|| {norm(m64.B_raw(u64_start)):.3e} -> "
        f"{norm(m64.B_raw(u64)):.3e}, max |u3 - u0| "
        f"{float((u64 - u64_start).abs().max()):.3e}, launches "
        f"{dict(bm.LAUNCHES)}")
    check(bm.LAUNCHES["batched_local_matvec"] > 0,
          "batched_local_matvec never launched in the f64 steps")
    check(max(c["project"] for c in counts64) < 2000,
          "the f64 projection CG ran into maxsteps")
    return launches


def check_stream(torch, bm, sm, timer, reports):
    """Rows 9-13 on the bench shape: every variant of the ported
    microbenchmark (``scripts.microbench_dma.variants``) against
    ``block_mv_plain`` on the same N(0,1) inputs (f32: max abs error <=
    1e-4, the bound the other f32 kernels are held to) and BITWISE against
    ``block_mv`` (every variant keeps its per-row fmaf order), then
    ``block_mv_soa`` against the SoA einsum.  A report sums its variants;
    ``torch.bmm`` on the same inputs is the library yardstick."""
    import numpy as np

    from navier_stokes_tpu_torch.scripts import microbench_dma

    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.standard_normal(
        (BENCH_NBLK, BENCH_NB, BENCH_NB)).astype(np.float32), device="cuda")
    x = torch.as_tensor(rng.standard_normal(
        (BENCH_NBLK, BENCH_NB)).astype(np.float32), device="cuda")
    want, ref = bm.block_mv_plain(A, x), bm.block_mv(A, x)
    xb = x[:, :, None]
    plain_ms = timer(lambda: bm.block_mv_plain(A, x))
    lib_ms = timer(lambda: torch.bmm(A, xb))
    nb_ = nbytes(A, x, want)
    bound = nb_ / HBM_BYTES_PER_S * 1e3
    log(f"[kernels] rows 9-12 on {tuple(A.shape)} f32 (the bench table, "
        f"{A.numel() * 4 / 1e6:.1f} MB): plain {plain_ms:.4f} ms, bmm "
        f"{lib_ms:.4f}, bound {bound:.4f}")
    for label, kernel, apply in microbench_dma.variants(A):
        if kernel in ("library", "block_mv"):
            continue
        name = kernel + "_seq" if kernel == "block_mv_splitk" else kernel
        y = apply(x)
        torch.cuda.synchronize()
        err = float((y - want).abs().max())
        check(bool(torch.isfinite(y).all()), f"{label}: non-finite")
        check(err <= 1e-4, f"{label}: max abs error {err:.3e} > 1e-4")
        check(torch.equal(y, ref), f"{label}: not bitwise equal to block_mv")
        ms = timer(lambda: apply(x))
        reports[name].add(ms, plain_ms, lib_ms, nb_, 2 * A.numel(), err)
        log(f"  {name} {label}: max|d plain|={err:.3e}, bitwise = "
            f"block_mv | kernel {ms:.4f} ms ({bound / ms:.3f} of bound)")

    # row 13: the structure-of-arrays table, padded as the script pads it
    ne_p = -(-BENCH_NBLK // 256) * 256
    A2 = torch.zeros((BENCH_NB, BENCH_NB, ne_p), device="cuda")
    A2[:, :, :BENCH_NBLK] = A.permute(1, 2, 0)
    uT = torch.zeros((BENCH_NB, ne_p), device="cuda")
    uT[:, :BENCH_NBLK] = x.T
    y = sm.block_mv_soa(A2, uT)
    y_ref = sm.block_mv_soa_plain(A2, uT)
    torch.cuda.synchronize()
    err = float((y - y_ref).abs().max())
    check(bool(torch.isfinite(y).all()), "block_mv_soa: non-finite")
    check(err <= 1e-4, f"block_mv_soa: max abs error {err:.3e} > 1e-4")
    check(float(y[:, BENCH_NBLK:].abs().max()) == 0.0,
          "block_mv_soa: padding columns came out non-zero")
    same = torch.equal(y[:, :BENCH_NBLK].T, ref)
    check(same, "block_mv_soa: not bitwise equal to block_mv on the AoS "
          "table")
    ms = timer(lambda: sm.block_mv_soa(A2, uT))
    plain_ms = timer(lambda: sm.block_mv_soa_plain(A2, uT))
    A2b, uTb = A2.permute(2, 0, 1), uT.T[:, :, None]  # views: same inputs
    lib_ms = timer(lambda: torch.bmm(A2b, uTb))
    nb_ = nbytes(A2, uT, y)
    reports["block_mv_soa"].add(ms, plain_ms, lib_ms, nb_, 2 * A2.numel(),
                                err)
    log(f"  block_mv_soa {tuple(A2.shape)} f32: max|d plain|={err:.3e}, "
        f"bitwise = block_mv on the AoS table, padding columns zero | kernel "
        f"{ms:.4f} ms, plain (einsum ije,je->ie) {plain_ms:.4f}, bmm on the "
        f"permuted views {lib_ms:.4f}, bound "
        f"{nb_ / HBM_BYTES_PER_S * 1e3:.4f}")


def microbench_phase(bm):
    """Both ported microbenchmark scripts at full width, with the launch
    counters set to 0 just before; each of the five wrappers must have
    launched.  Returns the launch counts."""
    from navier_stokes_tpu_torch.scripts import (
        microbench_apply2,
        microbench_dma,
    )

    bm.reset_launches()
    log(f"[microbench] scripts.microbench_dma.main({BENCH_NBLK}, {BENCH_NB})")
    rows = microbench_dma.main(BENCH_NBLK, BENCH_NB)
    log(f"[microbench] scripts.microbench_apply2.main({MAXH})")
    rows2 = microbench_apply2.main(MAXH)
    launches = dict(bm.LAUNCHES)
    log(f"[microbench] launches {launches}")
    check(all(r["ms"] is not None and r["ms"] > 0 for r in rows + rows2),
          "[microbench] a variant was not timed")
    for name in ("block_mv_rows", "block_mv_splitk", "block_mv_mega",
                 "block_mv_ring", "block_mv_soa"):
        check(launches[name] > 0, f"{name} never launched in [microbench]")
    best = min((r for r in rows if r["kernel"] != "library"),
               key=lambda r: r["ms"])
    log(f"[microbench] fastest variant: {best['label']} {best['ms']:.4f} ms "
        f"({best['share']:.3f} of bound)")
    return launches


def amg_phase(torch, bm, build_model, FlagshipSolve, cylinder_geometry):
    """The SA-AMG coarse solve on a mesh whose P1 coarse spaces exceed the
    dense limit of 5,000 free vertices: (a) AMG-preconditioned CG on the P1
    stiffness, (b) the curved GS flagship solve cold and warm, (c) one cold
    and three warm f32 transient steps."""
    import numpy as np

    from navier_stokes_tpu_torch.fem.spaces import H1
    from navier_stokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_mesh_3d,
    )
    from navier_stokes_tpu_torch.ops import assembly as asm
    from navier_stokes_tpu_torch.precond.amg import build_sa_amg
    from navier_stokes_tpu_torch.solvers.cg import cg

    t0 = time.perf_counter()
    mesh = channel_with_cylinder_mesh_3d(AMG_MAXH)
    space = H1(mesh, 1, dirichlet="inlet|wall|cyl")
    free_np = space.free_mask
    nfree = int(free_np.sum())
    log(f"[amg] maxh={AMG_MAXH}: {mesh.ne} tets, {mesh.nv} vertices, "
        f"{nfree} free velocity-P1 vertices (mesh "
        f"{time.perf_counter() - t0:.1f} s)")
    check(nfree > 5000, f"[amg] only {nfree} free coarse vertices: the dense "
          "inverse would be taken")

    # (a) PCG on the P1 stiffness with one V-cycle as preconditioner
    t0 = time.perf_counter()
    K_loc = asm.stiffness_local(space)
    K = asm.assemble_csr(K_loc, space.element_dofs, space.ndof)
    pre = build_sa_amg(K, free_np, torch.float64, "cuda")
    torch.cuda.synchronize()
    t_amg = time.perf_counter() - t0
    free = torch.as_tensor(free_np, device="cuda")
    K_t = torch.as_tensor(K_loc, device="cuda")
    eld = torch.as_tensor(space.element_dofs.astype(np.int64), device="cuda")

    def A(v):
        vf = torch.where(free, v, 0.0)
        return torch.where(
            free, asm.apply_local_matrices(K_t, eld, space.ndof, vf), v)

    rng = np.random.default_rng(0)
    b, x, y = (torch.as_tensor(rng.standard_normal(space.ndof) * free_np,
                               device="cuda") for _ in range(3))
    res = cg(A, b, pre=pre, tol=1e-8, maxsteps=200)
    plain = cg(A, b, tol=1e-8, maxsteps=2000)
    a1, a2 = float(torch.dot(pre(x), y)), float(torch.dot(x, pre(y)))
    true_rel = float(torch.linalg.norm(b - A(res.x)) / torch.linalg.norm(b))
    log(f"[amg] (a) build_sa_amg {t_amg:.1f} s, {pre.levels} ELL levels; "
        f"PCG to 1e-8 in {res.iterations} iterations (plain CG "
        f"{plain.iterations}), |b - K x|/|b| {true_rel:.3e}; symmetry "
        f"|<Px,y> - <x,Py>| / |<Px,y>| = {abs(a1 - a2) / abs(a1):.3e}")
    check(res.converged and res.iterations < 40,
          f"[amg] PCG took {res.iterations} iterations")
    check(pre.levels >= 1, "[amg] the hierarchy has no ELL level")
    check(abs(a1 - a2) <= 1e-10 * abs(a1), "[amg] the V-cycle is not "
          "symmetric")
    check(float(torch.dot(x, pre(x))) > 0, "[amg] the V-cycle is not "
          "positive")
    check(true_rel <= 1e-6, f"[amg] PCG residual {true_rel:.3e}")

    # (b) the curved GS flagship solve, its coarse correction through AMG
    t0 = time.perf_counter()
    geo = cylinder_geometry(mesh)
    cache = {}
    m = build_model(AMG_MAXH, order=ORDER, nu=NU, device="cuda", mesh=mesh,
                    geometry=geo, assembly_cache=cache)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = FlagshipSolve(m, tol=TOL)
    t_ops = time.perf_counter() - t0
    parts = solver.ops32["preA"].parts
    log(f"[amg] (b) {len(geo.curved_elements)} curved tets, ndof={m.n}+"
        f"{m.Q.ndof}; model build {t_model:.1f} s, GS ops {t_ops:.1f} s, "
        f"{len(parts['groups'])} colors, coarse AMG levels "
        f"{parts['coarse_amg_levels']}, coarse lambda "
        f"{parts['coarse_lambda']:.4f}")
    check(parts["coarse_amg_levels"] >= 1,
          "[amg] the skeleton preconditioner took the dense coarse inverse")
    cold, launches = solve_and_check(torch, bm, solver, "amg curved GS cold")
    warm, _ = solve_and_check(torch, bm, solver, "amg curved GS warm")
    for name in ("block_mv", "block_mv2", "block_mv_comp"):
        check(launches.get(name, 0) > 0, f"{name} never launched in [amg]")
    log(f"[amg] (b) inner iterations {warm.inner} at maxh={AMG_MAXH} "
        f"(maxh={MAXH}: 358), warm {warm.seconds:.3f} s")
    del solver, cold, warm

    # (c) one cold and three warm f32 steps
    t0 = time.perf_counter()
    m32 = build_model(AMG_MAXH, order=ORDER, nu=NU, device="cuda", mesh=mesh,
                      geometry=geo, assembly_cache=cache,
                      dtype=torch.float32)
    del cache, m
    step = m32.make_step_fn(project_tol=PROJECT_TOL32, mstar_tol=MSTAR_TOL)
    torch.cuda.synchronize()
    pre2 = m32._pre_proj_twolevel()
    log(f"[amg] (c) f32 twin and step setup {time.perf_counter() - t0:.1f} "
        "s: " + ", ".join(f"{k} {v:.1f} s"
                          for k, v in m32.setup_seconds.items())
        + f"; projection coarse AMG levels {pre2.coarse_amg_levels}")
    check(pre2.coarse_amg_levels >= 1,
          "[amg] the projection preconditioner took the dense coarse inverse")
    u, counts, secs = m32.u, [], []
    bm.reset_launches()
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = step(u)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts.append(dict(m32.last_iterations))
        check(bool(torch.isfinite(u).all()), "[amg] a step is not finite")
    ms_, pr_ = ([c[k] for c in counts] for k in ("mstar", "project"))
    log(f"[amg] (c) cold step {secs[0]:.3f} s, warm steps "
        + ", ".join(f"{t:.3f}" for t in secs[1:])
        + f" s; M* CG {ms_}, projection CG {pr_}; "
        f"{bm.LAUNCHES['batched_local_matvec']} batched_local_matvec "
        f"launches; max |u| {float(u.abs().max()):.4f}")
    check(max(pr_) < 2000 and max(ms_) < 2000, "[amg] a CG ran into maxsteps")

    projection_check(torch, m32, u, "[amg] (c)")


def redesign_order(entries, reports):
    """The order in which the kernels are worth redesigning: first those
    slower than the one PyTorch call for the same function, by the factor;
    then the rest by the time their path loses to them, launches x (ms -
    bound) per launch (a report's ms and bound are sums over its checks)."""
    slower = sorted((e for e in entries if e["ms"] > e["library_ms"]),
                    key=lambda e: e["library_ms"] / e["ms"])
    rest = sorted((e for e in entries if e["ms"] <= e["library_ms"]),
                  key=lambda e: -e["launches"] * (e["ms"] - e["bound_ms"])
                  / reports[e["name"]].n)
    for e in slower + rest:
        lost = (e["launches"] * (e["ms"] - e["bound_ms"])
                / reports[e["name"]].n)
        log(f"[redesign] {e['name']:22s} {e['ms'] / e['library_ms']:.3f} x "
            f"the library call ({e['ms']:.4f} against {e['library_ms']:.4f} "
            f"ms), bound {e['bound_ms']:.4f}; {e['launches']} launches x "
            f"{(e['ms'] - e['bound_ms']) / reports[e['name']].n:.4f} ms over "
            f"the bound = {lost:.1f} ms on its path")


# -- the run ---------------------------------------------------------------------


def run():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "navier_stokes_tpu_torch")):
        print("chip_smoke: navier_stokes_tpu_torch/ not found beside "
              "chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from navier_stokes_tpu_torch.flagship import (
        FlagshipSolve,
        build_model,
        cylinder_geometry,
    )
    from navier_stokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_mesh_3d,
    )
    from navier_stokes_tpu_torch.ops import block_mv as bm
    from navier_stokes_tpu_torch.ops import local_mv as lm
    from navier_stokes_tpu_torch.ops import stream_mv as sm
    from navier_stokes_tpu_torch.utils.timers import Timer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")

    # 1. build
    t0 = time.perf_counter()
    built = bm.build_all(verbose=True)
    bm.load_library()
    lm.load_library()
    sm.load_library()
    log("[build] " + ", ".join(f"{path.name}: nvcc {secs:.1f} s"
                               for path, secs in built.values())
        + f" (all at once, with load {time.perf_counter() - t0:.1f} s)")
    card = card_line()
    log(f"[card] {card}")

    # 2. setup: the main path (curved, GS) and slice 1's (straight, additive)
    t0 = time.perf_counter()
    mesh = channel_with_cylinder_mesh_3d(MAXH)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    geo = cylinder_geometry(mesh)
    t_curve = time.perf_counter() - t0
    t0 = time.perf_counter()
    cache = {}  # host tables, shared with the f32 stepping model
    m = build_model(MAXH, order=ORDER, nu=NU, device="cuda", mesh=mesh,
                    geometry=geo, assembly_cache=cache)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = FlagshipSolve(m, tol=TOL)
    t_ops = time.perf_counter() - t0
    parts = solver.ops32["preA"].parts
    ncolors = len(parts["groups"])
    log(f"[setup] maxh={MAXH}: {mesh.ne} tets, {mesh.nv} vertices, "
        f"{len(geo.curved_elements)} curved tets, ndof={m.n}+{m.Q.ndof}")
    log(f"[setup] curved GS: mesh {t_mesh:.1f} s, curve {t_curve:.1f} s, "
        f"model build {t_model:.1f} s, GS ops {t_ops:.1f} s "
        + ", ".join(f"({k} {v:.1f} s)" for k, v in
                    solver.setup_seconds.items())
        + "; " + ", ".join(f"{k} {v:.1f} s" for k, v in
                           parts["setup_seconds"].items())
        + f"; {ncolors} colors, coarse lambda {parts['coarse_lambda']:.4f}, "
        f"theta {parts['coarse_theta']:.4f}")
    check(m.n == 243312 and m.Q.ndof == 30960,
          f"unexpected size {m.n}+{m.Q.ndof}")
    check(len(geo.curved_elements) == 335,
          f"{len(geo.curved_elements)} curved tets, expected 335")
    t0 = time.perf_counter()
    m_s = build_model(MAXH, order=ORDER, nu=NU, device="cuda", mesh=mesh,
                      curved=False)
    torch.cuda.synchronize()
    t_model_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver_s = FlagshipSolve(m_s, tol=TOL, gs=False)
    t_ops_s = time.perf_counter() - t0
    log(f"[setup] straight additive: model build {t_model_s:.1f} s, "
        f"operators {t_ops_s:.1f} s")
    check(m_s.n == 243312 and m_s.Q.ndof == 30960,
          f"unexpected size {m_s.n}+{m_s.Q.ndof}")

    # the f32 stepping model (bench.py:210) and the step's lazy setup
    t0 = time.perf_counter()
    m32 = build_model(MAXH, order=ORDER, nu=NU, device="cuda", mesh=mesh,
                      geometry=geo, assembly_cache=cache,
                      dtype=torch.float32)
    torch.cuda.synchronize()
    t_model32 = time.perf_counter() - t0
    del cache
    t0 = time.perf_counter()
    step32 = m32.make_step_fn(project_tol=PROJECT_TOL32, mstar_tol=MSTAR_TOL)
    torch.cuda.synchronize()
    alpha, beta = m32._mass_chebyshev().bounds
    log(f"[setup] transient f32: model build {t_model32:.1f} s (host tables "
        f"shared), step setup {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in m32.setup_seconds.items())
        + f"; Chebyshev bounds ({alpha:.5f}, {beta:.5f})")
    check(m32.dtype == torch.float32 and m32.u.dtype == torch.float32,
          "the stepping model is not float32")
    check(m32.n == m.n and m32.Q.ndof == m.Q.ndof, "the twin differs in size")

    # 3. kernel checks on the main path's tables (and slice 1's)
    timer = Timer()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    reports = {
        "block_mv": KernelReport("block_mv", f"{PALLAS}:118"),
        "block_mv2": KernelReport("block_mv2", f"{PALLAS}:124"),
        "block_mv_comp": KernelReport("block_mv_comp", f"{PALLAS}:166"),
        "block_mv_splitk": KernelReport("block_mv_splitk", f"{PALLAS}:305"),
        "block_mv2_splitk": KernelReport("block_mv2_splitk",
                                         f"{PALLAS}:358"),
        "block_mv_comp_splitk": KernelReport("block_mv_comp_splitk",
                                             f"{PALLAS}:397"),
        "block_mv_ds": KernelReport("block_mv_ds", f"{PALLAS}:129"),
        "batched_local_matvec": KernelReport(
            "batched_local_matvec", f"{PALLAS_LOCAL}:26", SRC_LOCAL),
        "block_mv_rows": KernelReport("block_mv_rows", f"{DMA}:92",
                                      SRC_STREAM),
        "block_mv_splitk_seq": KernelReport("block_mv_splitk_seq",
                                            f"{DMA}:119"),
        "block_mv_mega": KernelReport("block_mv_mega", f"{DMA}:179",
                                      SRC_STREAM),
        "block_mv_ring": KernelReport("block_mv_ring", f"{DMA}:220",
                                      SRC_STREAM),
        "block_mv_soa": KernelReport("block_mv_soa", f"{APPLY2}:123",
                                     SRC_STREAM),
    }
    for label, s, keep in (("curved GS (main path)", solver, True),
                           ("straight additive", solver_s, False)):
        o32, ods = s.ops32, s.ops_ds

        def rep(name):
            return reports[name] if keep else None

        log(f"[kernels] {label}: block_mv on every table of one preA apply")
        real = solve_table_real_bytes(o32["preA"].parts)
        for tname, A in o32["preA"].parts["tables"].items():
            check_block_mv(torch, bm, timer, rep("block_mv"), tname, A, gen,
                           real.get(tname))
        if real:
            tabs_ = o32["preA"].parts["tables"]
            merged = sum(nbytes(tabs_[t]) for t in real)
            log(f"[kernels] {label}: the GS solve tables hold "
                f"{merged / 1e6:.1f} MB, of which "
                f"{sum(real.values()) / 1e6:.1f} MB are real inverse blocks")
        log(f"[kernels] {label}: block_mv2 on the split-f32 A32, B32, BT32")
        for tname, op in (("A32", o32["A"]), ("B32", o32["B"]),
                          ("BT32", o32["BT"])):
            check_block_mv2(torch, bm, timer, rep("block_mv2"), tname,
                            *op.tables, gen)
        log(f"[kernels] {label}: block_mv_comp on A_ds, B_ds, BT_ds")
        for tname, op in (("A_ds", ods["A"]), ("B_ds", ods["B"]),
                          ("BT_ds", ods["BT"])):
            hi, lo = op.tables
            x64 = torch.randn((hi.shape[0], hi.shape[2]), generator=gen,
                              device="cuda", dtype=torch.float64)
            check_comp(torch, bm, timer, rep("block_mv_comp"), tname, hi, lo,
                       x64)
    for nblk, nb in ((37, 14), (m.fb.ne, m.fb.nb)):
        hi, lo, x64 = cancellation_case(torch, nblk, nb, 11)
        check_comp(torch, bm, timer, None, "cancellation 1e5", hi, lo, x64,
                   timed=False)

    o32, ods = solver.ops32, solver.ops_ds
    tabs = parts["tables"]
    for k in (SPLIT_K, 4):  # the JSON line reports the split-k path's k
        def rep(name):
            return reports[name] if k == SPLIT_K else None

        log(f"[kernels] split-k at k={k} on the main path's tables")
        for tname in ("S", "ext", "ext^T", "inner", "M_F", "M_F^T"):
            check_splitk(torch, bm, timer, rep("block_mv_splitk"), tname,
                         "mv", [tabs[tname]], k, TILE, gen)
        check_splitk(torch, bm, timer, rep("block_mv2_splitk"), "A32", "mv2",
                     o32["A"].tables, k, TILE, gen)
        for tname, tile in (("A_ds", TILE), ("B_ds", TILE_COMP),
                            ("BT_ds", TILE_COMP)):
            check_splitk(torch, bm, timer, rep("block_mv_comp_splitk"),
                         tname, "comp", ods[tname[:-3]].tables, k, tile, gen)
        for nblk, nb in ((37, 14), (m.fb.ne, m.fb.nb)):
            hi, lo, x64 = cancellation_case(torch, nblk, nb, 11)
            check_splitk(torch, bm, timer, None, "cancellation 1e5", "comp",
                         [hi, lo], k, 8 if nblk < 100 else TILE, gen,
                         x64=x64, timed=False)

    log("[kernels] batched_local_matvec on the transient step's tables "
        "(f32: the stepping model's, reported; f64: the model's own)")
    for mm, keep in ((m32, True), (m, False)):
        pre2 = mm._pre_proj_twolevel()
        for tname, A in (("M_loc", mm._M_loc), ("A_cond", mm._A_cond),
                         ("S_inv", pre2.S_inv)):
            check_local_mv(torch, lm, timer,
                           reports["batched_local_matvec"] if keep else None,
                           tname, A, gen)
    log("[kernels] block_mv_ds on the split A, B, BT tables")
    for tname, op in (("A_ds", ods["A"]), ("B_ds", ods["B"]),
                      ("BT_ds", ods["BT"])):
        check_ds(torch, bm, timer, reports["block_mv_ds"], tname, *op.tables,
                 gen)

    check_stream(torch, bm, sm, timer, reports)

    # 4. main path: the curved GS solve, cold then warm
    cold, launches = solve_and_check(torch, bm, solver, "curved GS cold",
                                     MAX_INNER)
    for name in ("block_mv", "block_mv2", "block_mv_comp"):
        check(launches.get(name, 0) > 0, f"{name} never launched on the "
              "main path")
    warm, _ = solve_and_check(torch, bm, solver, "curved GS warm", MAX_INNER)

    # 5. slice 1's path: straight additive, cold, warm, phase-2 polish
    _, launches_s = solve_and_check(torch, bm, solver_s,
                                    "straight additive cold")
    for name in ("block_mv", "block_mv2", "block_mv_comp"):
        check(launches_s.get(name, 0) > 0, f"{name} never launched on the "
              "straight additive path")
    warm_s, _ = solve_and_check(torch, bm, solver_s, "straight additive warm")
    # phase 2 on its own: phase 1 already meets 1e-8 there, so the
    # compensated MINRES passes polish the warm solution to 1e-10
    bm.reset_launches()
    p2_log = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x0, x1, rel2, inner2 = solver_s.phase2(*warm_s.x, warm_s.rel, p2_log, t0,
                                           tol=1e-10)
    torch.cuda.synchronize()
    t_p2 = time.perf_counter() - t0
    true2 = solver_s.true_rel(*solver_s.residual64(x0, x1))
    for line in p2_log:
        log(f"  polish {line}")
    log(f"[solve] straight additive phase-2 polish to 1e-10: inner={inner2}, "
        f"{t_p2:.3f} s, ds rel {rel2:.3e}, true f64 rel {true2:.3e}, "
        f"launches {dict(bm.LAUNCHES)}")
    check(inner2 > 0 and bm.LAUNCHES["block_mv_comp"] > 0,
          "phase 2 did not run")
    check(true2 <= warm_s.true_rel, f"phase 2 raised the residual to {true2}")

    # 6. split-k path on the curved model
    t0 = time.perf_counter()
    solver_k = FlagshipSolve(m, tol=TOL, split_k=SPLIT_K)
    log(f"[setup] split_k={SPLIT_K} GS ops {time.perf_counter() - t0:.1f} s")
    split, launches_k = solve_and_check(torch, bm, solver_k,
                                        f"curved GS split_k={SPLIT_K}",
                                        MAX_INNER)
    for name in ("block_mv_splitk", "block_mv2_splitk",
                 "block_mv_comp_splitk"):
        check(launches_k.get(name, 0) > 0, f"{name} never launched on the "
              "split-k path")
    check(split.inner == warm.inner,
          f"split_k={SPLIT_K} took {split.inner} inner iterations, "
          f"split_k=1 {warm.inner}")

    # 7. per-apply milliseconds (bench.py probe_ops)
    apply_probes(torch, "curved GS", solver)
    apply_probes(torch, f"split_k={SPLIT_K}", solver_k)
    apply_probes(torch, "straight additive", solver_s)

    # 8. where a phase-1 iteration's time goes
    profile_minres(torch, solver, "curved GS")
    profile_minres(torch, solver_s, "straight additive")

    # 9. the plain double-single residual of the converged solution
    launches_ds = ds_phase(torch, bm, solver, warm)

    # 10. the transient step: f32 as bench.py, then f64 from the solution
    launches_t = transient_phase(torch, bm, m32, step32, m,
                                 m.u_bc + warm.x[0])

    # 11. this slice's path: the two ported microbenchmark scripts
    launches_mb = microbench_phase(bm)

    # 12. the SA-AMG coarse solve on a mesh above the dense limit
    amg_phase(torch, bm, build_model, FlagshipSolve, cylinder_geometry)

    counts = {**{k: launches[k] for k in ("block_mv", "block_mv2",
                                          "block_mv_comp")},
              **{k: launches_k[k] for k in ("block_mv_splitk",
                                            "block_mv2_splitk",
                                            "block_mv_comp_splitk")},
              "block_mv_ds": launches_ds,
              "batched_local_matvec": launches_t["batched_local_matvec"],
              **{k: launches_mb[k] for k in ("block_mv_rows", "block_mv_mega",
                                             "block_mv_ring",
                                             "block_mv_soa")},
              "block_mv_splitk_seq": launches_mb["block_mv_splitk"]}
    kernels = {"kernels": [rep.entry(counts[name])
                           for name, rep in reports.items()]}
    redesign_order(kernels["kernels"], reports)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main():
    try:
        return run()
    except Fail as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())

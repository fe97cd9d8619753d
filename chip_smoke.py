#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``navier_stokes_tpu_torch``) on one GPU.

Drives the port's paths -- the initial Stokes solve of the 3D MCS channel
with cylinder at maxh=0.09, order 2, nu=1e-3, to a true f64 relative
residual of 1e-8, and the transient SIMPLE step on its float32 twin -- in
phases; any failed phase ends the run with a non-zero exit:

1. build: compile ``navier_stokes_tpu_torch/csrc/block_mv.cu``,
   ``local_mv.cu`` and ``stream_mv.cu`` with nvcc (sm_90a), all at once,
   and print the build seconds and the card;
2. cuda-tests: ``python -m pytest --noconftest -m cuda
   tests/test_torch_cuda.py`` from the repository root -- the card-only
   tests, which import no JAX -- must pass all 29 cases, none skipped;
3. setup: the mesh, then the MAIN PATH's configuration -- bench.py's
   default: order-3 curved cylinder (335 curved tets), symmetric multicolor
   block-GS skeleton preconditioner, bf16 extension and inverse tables,
   coarse damping target 1.6 -- and slice 1's straight additive
   configuration, seconds per phase and the GS color count;
4. kernel checks: every kernel wrapper on the main path's own device tables
   (and on an engineered cancellation case) against its plain PyTorch
   version on the same inputs, within the stated bounds, with its median
   time, its byte bound, the plain version's time and one PyTorch library
   call's time as a yardstick; the split-k kernels at k=2 and k=4 on the
   same tables, also BITWISE against their unsplit kernels; slice 1's
   tables are checked the same way.  The GS solve tables, stored by
   segment, go through ``block_mv_segments`` (counted as ``block_mv``),
   held EQUAL (``torch.equal``) to ``block_mv`` on the padded table they
   stand for, with the bytes each streams in either layout.  A bound
   counts the bytes the function needs: the split-k kernels' on the
   unsplit tables (their zero pad is not loaded), the GS solve tables' on
   their real inverse blocks;
5. main path: launch counters set to 0, ``FlagshipSolve.full_solve`` of the
   curved GS configuration cold, counters read; every unsplit kernel must
   have launched; then a warm solve; the true-f64 residual of each must be
   <= 1.01e-8 in at most 460 inner iterations;
6. slice 1's path: the straight additive solve cold and warm, and phase 2
   alone polishing the warm solution to 1e-10;
7. split-k path: ``FlagshipSolve(m, split_k=2)`` on the curved model, one
   warm solve with the counters set to 0 just before it; each split-k
   kernel must launch, the residual must meet 1.01e-8 and the inner count
   must equal the split_k=1 solve's;
8. per-apply milliseconds (bench.py's probe_ops, CUDA events) of both
   configurations, with the GS parts: S_faces, one color step, coarse_gs;
9. profile: the device busy share of 100 phase-1 MINRES iterations
   (torch.profiler kernel time over unprofiled wall time) of each
   configuration and the kernels that take most of it;
10. ds: the residual of the converged solution through the plain 3 x f32
   double-single applies (``elem_apply_ds`` / ``rect_apply_ds``, one
   ``block_mv_ds`` launch each: kernel 3, the split-k kernel at one
   sub-table with three fmaf chains per row) beside the compensated one,
   both against the true f64 residual;
11. bpcg: the 3D model's own initial solve on the curved f64 model,
    ``SolveInitial(iterative=True, GS=True, tol=1e-8, maxsteps=20000)``
    with the default auxspace preconditioner (the skeleton preconditioner
    in f64 with the JAX model's settings, its tables applied by plain
    batched products: no kernel lies on this path): iterations (band
    165-190), setup and solve seconds, ``stokes_bpcg_time``, the true f64
    relative residual of the saddle system (bound 5e-8) and the relative
    velocity difference from the flagship solution (bound 2e-7), two f32
    controls that must break those bounds, and the device busy share of
    50 iterations; then the two faceblock variants, additive and
    multicolor GS, on the shortened channel of
    tests/test_navier_stokes_mcs3d.py at maxh=0.35: kernel 8 on their f64
    block inverses against its plain version, and a solve with their own
    Bramble-Pasciak k and one with the JAX package's, held to its count;
    the model's state is put back;
12. transient: the float32 twin of the curved model (same host tables),
    ``make_step_fn(project_tol=1e-5)`` from ``u = u_bc`` as bench.py's
    ``measure_transient``: one cold step with the launch counters set to 0
    just before it, then n warm steps (n calibrated to about 10 s, 3..200):
    steps/s, the M* and projection CG counts of every step, the
    projection's reduction of ||B u||, whether a step is bitwise
    repeatable, per-piece milliseconds and the device busy share; then 3
    float64 steps (project_tol=1e-9) from the flagship solution, the
    counters read after the first; then repeat: two f32 steps from the
    same state must give bitwise equal increments and equal CG counts
    (every scatter of the port is a deterministic ``ScatterPlan``);
13. bench: the port's bench line (``navier_stokes_tpu_torch.bench.measure``
    on the models already built and the main path's cold and warm flagship
    solves, checked within 460 inner iterations, then calibrated warm f32
    steps), its keys checked;
    printed on a line before the kernels' line; then refine:
    ``mixed_precision_minres_refinement_2phase`` to 1e-8 on the main
    path's model and its ``equilibrated_f32_ops(gs=True)``, once with the
    native f64 A, B, B^T as ops64 and once with the compensated
    ``block_mv_comp`` operators wrapped back to the unscaled system (held
    to the native ones within 1e-12 first): passes, inner iterations, the
    true f64 residual (<= 1.01e-8) and seconds of each;
14. microbench: the two ported microbenchmark scripts
    (``navier_stokes_tpu_torch.scripts.microbench_dma`` on the
    7740 x 54 x 54 f32 table, ``microbench_apply2`` at maxh=0.09) with the
    launch counters set to 0 just before; each of the five table-stream
    wrappers must have launched, and the split-k variants must be bitwise
    equal to ``block_mv``;
15. amg: at maxh=0.04 (5,859 free velocity-P1 vertices, above the dense
    limit of 5,000, so both coarse solves are SA-AMG V-cycles):
    AMG-preconditioned CG on the P1 stiffness to 1e-8 in under 40
    iterations with the V-cycle symmetric to 1e-10, the curved GS flagship
    solve cold and warm to a true f64 residual <= 1.01e-8, and one cold and
    three warm float32 transient steps;
16. hdg3d: ``NavierStokesHDG3D`` at the demo's configuration
    (scripts/navier_stokes_3d.py --hdg, the reference's
    NavierStokesSIMPLE_test_3D.py: the straight channel at maxh=0.09,
    order 2, nu=1e-3, dt=2e-3, the auxspace preconditioner with 1,794
    vertex-star blocks of up to 1,056 dofs, their inverses taken on the
    card in f64), after the MCS models are let go: setup seconds by part;
    kernel 8 on its f64 element and vertex-star tables against the plain
    version; ``SolveInitial(tol=1e-8)`` (BPCG iterations, seconds, launches
    per iteration, true f64 residual <= 1.01e-8); ``Project`` (||B u|| <
    1e-7); two steps from the same state bitwise equal; 3 ``DoTimeStep``s
    (finite, steps/s, CG counts, launches per step); an f32 twin whose
    kernel-8 and kernel-1 tables are checked the same way, and
    ``solve_initial_refined`` on the pair (its guard: a finite result
    below the starting residual, reported).

The kernel checks of phase 4 also cover ``batched_local_matvec`` (float32
and float64, each its own entry of the kernels line, on the mass,
condensed-operator and pressure-block tables of the transient step),
``block_mv_ds`` (on the split A, B, BT tables, each output also BITWISE
against ``block_mv`` on its (table, vector) pair), every variant of the
table-stream kernels (``block_mv_rows``, split-k at k = 2, 4, 8,
``block_mv_mega``, ``block_mv_ring``, ``block_mv_soa``) on the bench table,
each also bitwise against ``block_mv``, the edges of the CTA stretches
of kernels 1, 2, 3 and 5-8 and of the segment entry (``check_edges``: the
shapes of the card tests), and those of kernels 9 and 13
(``check_stream_edges``: rows per CTA 1, 5, 864 and odd k; element counts
4, 260, 7936 and nb 1, 7, 64).  A ``[stream]`` line prints what ``A.sum()``
on the bench table reaches of the byte bound, for reference only.

It prints the bench line, the kernels' JSON line and the card's name and
power limit on lines before the last, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

T_START = time.perf_counter()

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
F64_FLOPS_PER_S = 34e12  # H100 SXM f64 outside the tensor cores
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
# kernels already redesigned for this card, and how
REDESIGNED = {"block_mv": "kernel 5 at one sub-table; the GS solves by "
                          "segment, without padding",
              "block_mv2": "kernel 6 at one sub-table",
              "block_mv_ds": "kernel 4's staging, three fmaf chains per row",
              "block_mv_comp_splitk": "bulk copies, x in shared memory",
              "block_mv_comp": "kernel 7 at one sub-table",
              "block_mv_splitk": "kernel 7's staging, bf16 copied as "
                                 "stored, one fmaf chain per row",
              "block_mv_splitk_seq": "kernel 5 on the bench table",
              "block_mv2_splitk": "kernel 7's staging, two fmaf chains per "
                                  "row",
              "batched_local_matvec": "bulk copy per CTA",
              "batched_local_matvec_f64": "bulk copy per CTA",
              "block_mv_ring": "producer warp, consumer groups, full and "
                               "empty mbarriers",
              "block_mv_rows": "each warp stages its own rows by one bulk "
                               "copy on its own mbarrier and computes when "
                               "they land",
              "block_mv_soa": "tensor-map boxes through a producer/consumer "
                              "ring, u once per element tile"}
PROJECT_TOL32, PROJECT_TOL64, MSTAR_TOL = 1e-5, 1e-9, 1e-4
# [cuda-tests]: the card-only tests, JAX-free, run from the repository alone
CUDA_TESTS = "tests/test_torch_cuda.py"
CUDA_TEST_CASES = 29  # 19 tests, 29 cases with their parameters
# [bpcg]: the 3D model's own BPCG SolveInitial (auxspace GS, f64) on the
# curved model at maxh=0.09, and the two faceblock variants on the shortened
# channel of tests/test_navier_stokes_mcs3d.py:_channel3d
BPCG_TOL, BPCG_MAXSTEPS = 1e-8, 20000
# the curved GS count at maxh=0.09: 177 in every run on an NVIDIA H100
# 80GB HBM3 (700 W).  It falls as the mesh is refined, with the
# Bramble-Pasciak k (the preconditioned spectrum): 255 / 205 / 201 / 177
# at maxh 0.2 / 0.15 / 0.12 / 0.09 on the H100, 272 at 0.6 on the CPU
# (tools/bpcg_study.py).  The band allows a few percent of roundoff drift
# (reduction order) and fails a preconditioner that loses or gains
# strength
BPCG_COUNTS = (165, 190)
# the bounds sit between the sound reading on the H100 (true residual
# 6.918e-9, velocity 5.038e-8 off the flagship solution) and those of two
# f32 controls, the same iteration with outputs rounded to float32
# (tools/bpcg_study.py; the phase runs both): with preA's and preM's
# rounded the residual reads 3.452e-7 (the velocity 8.255e-8, which no
# bound can tell from 5.0e-8), with A's, B's and B^T's rounded the
# iteration diverges (residual 1.1e-1, velocity 1.9e-2).  The residual
# bound is the geometric middle of 6.9e-9 and 3.5e-7; the velocity bound
# four times the sound reading.  The phase fails unless each control
# breaks the bounds it can break.
BPCG_RES_BOUND = 5e-8  # true f64 relative residual of the saddle system
BPCG_DIFF_BOUND = 2e-7  # relative velocity difference from FlagshipSolve
BPCG_SMALL_MAXH = 0.35
# the JAX package's count and Bramble-Pasciak scaling k for each faceblock
# variant there, GS -> (iterations, k), on the CPU in f64
# (tools/jax_bpcg_reference.py); the port solves with that k and is held to
# the count within BPCG_SMALL_BAND (the GPU's reduction order differs)
BPCG_SMALL_JAX = {False: (931, 213.54712387600733),
                  True: (806, 664.0271504968791)}
BPCG_SMALL_BAND = 0.02
# [hdg3d]: NavierStokesHDG3D at the demo's configuration (the reference's
# NavierStokesSIMPLE_test_3D.py through scripts/navier_stokes_3d.py --hdg)
HDG_MAXH, HDG_MAXSTEPS = 0.09, 20000
# the edges of the split-k kernels' (5-7) and kernel 8's CTA stretches, as
# the card tests (nblk, m, k, tile): stretches across tile boundaries, rows
# * k not a multiple of 4 floats or 8 bf16 entries (ragged tails of up to 7
# entries), real rows ending mid-stretch, empty sub-tables
EDGE_SPLITK = ((37, 6, 7, 8), (300, 54, 54, 8), (301, 4, 54, 16),
               (45, 54, 4, 3), (5, 3, 7, 2), (19, 5, 3, 4), (203, 7, 9, 16))
# (ne, nb, offset in elements of the view into its allocation)
EDGE_LOCAL = ((700, 54, 0), (3001, 4, 0), (77, 12, 0), (77, 13, 0),
              (1, 1, 0), (1, 54, 0), (5, 130, 0), (700, 54, 1), (77, 13, 1),
              (3001, 4, 2), (5, 130, 3), (1, 1, 1))
# kernels 1 and 2 at one sub-table, as the card tests (nblk, m, k): m * k
# not whole 16-byte units, odd k in bf16, one block, stretches ending
# mid-block, blocks wider than a CTA's rows, rows of an even number of
# 16-byte vectors (k = 8, 16, 48, 96)
EDGE_UNSPLIT = ((1, 1, 1), (1, 54, 54), (37, 6, 7), (301, 4, 54),
                (45, 54, 4), (5, 3, 7), (19, 5, 3), (203, 7, 9),
                (7, 132, 132), (1000, 6, 6), (3, 300, 11), (130, 12, 96),
                (3, 5, 48), (7, 1, 16), (33, 3, 8))
# the segment entry, as the card tests: (count, d) per segment (d not a
# multiple of 8, a one-block segment, d = 16: rows of two or four 16-byte
# vectors) and the padded width
EDGE_SEGMENTS = (((5, 7), (1, 13), (9, 5), (3, 12), (4, 1), (6, 16)), 16)
# kernel 9 (block_mv_rows): (nblk, m, k) -- the bench block, odd k (rows
# read entry by entry), rows * k not whole 16-byte units -- at rows per CTA
# 0 (64), 1, 5 and 864, with the table and x views 0 or 1 float past a
# 16-byte boundary (ragged head floats; odd shifts)
EDGE_ROWS = ((700, 54, 54), (1001, 7, 13), (301, 4, 53))
EDGE_ROWS_R = (0, 1, 5, 864)
# kernel 13 (block_mv_soa): element counts (one partial tile, a partial last
# tile, the bench's padded count) x nb (one row, odd, the largest)
EDGE_SOA_NE, EDGE_SOA_NB = (4, 260, 7936), (1, 7, 64)


def log(*a):
    print(*a, flush=True)


class Fail(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Fail(msg)


# -- kernel checks --------------------------------------------------------------


class KernelReport:
    """Sums one kernel's checks over the shapes of the main path; ``rate``
    is the card's peak for the kernel's operations (f32 or f64)."""

    def __init__(self, name, replaces, source=SRC, rate=F32_FLOPS_PER_S):
        self.name, self.replaces, self.source = name, replaces, source
        self.rate = rate
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
        tf = self.flops / self.rate
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


def check_block_mv(torch, bm, timer, rep, label, A, gen):
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
    add(rep, ms, plain_ms, lib_ms, nb, 2 * A.numel(), float(err.max()))
    log(f"  block_mv {label} {tuple(A.shape)} {str(A.dtype)[6:]}: "
        f"max|d|={float(err.max()):.3e} rel={worst:.2e} | kernel {ms:.4f} ms"
        f", plain {plain_ms:.4f}, bmm {lib_ms:.4f}, bound "
        f"{nb / HBM_BYTES_PER_S * 1e3:.4f}")


def check_block_mv_segments(torch, bm, timer, rep, label, T, gen):
    """A GS solve table stored by segment (``bm.SegmentTable``):
    ``block_mv_segments`` EQUAL (``torch.equal``) to ``block_mv`` on the
    padded table it stands for and within 1e-5 of sum_j |a_ij x_j| of its
    plain version.  The bound counts the real blocks' bytes (and x, y);
    the yardstick stays ``torch.bmm`` on an f32 copy of the padded table,
    and ``block_mv`` on the padded table is timed beside it."""
    x = torch.randn((T.nblk, T.width), generator=gen, device="cuda")
    P = T.padded()
    y = bm.block_mv_segments(T, x)
    y_ref = bm.block_mv_segments_plain(T, x)
    y_pad = bm.block_mv(P, x)
    torch.cuda.synchronize()
    P32 = P.to(torch.float32)
    scale = torch.einsum("bmk,bk->bm", P32.abs().double(), x.abs().double())
    err = (y - y_ref).abs()
    worst = float((err.double() / scale.clamp_min(1e-300)).max())
    check(bool(torch.isfinite(y).all()), f"block_mv {label}: non-finite")
    check(worst <= 1e-5, f"block_mv {label}: {worst:.2e} > 1e-5 of sum|a x|")
    check(torch.equal(y, y_pad), f"block_mv {label}: the segments differ "
          "from block_mv on the padded table")
    xb = x[:, :, None]
    ms = timer(lambda: bm.block_mv_segments(T, x))
    plain_ms = timer(lambda: bm.block_mv_segments_plain(T, x))
    lib_ms = timer(lambda: torch.bmm(P32, xb))  # f32 copy: a yardstick
    pad_ms = timer(lambda: bm.block_mv(P, x))
    nb = T.real_bytes + nbytes(x, y)
    add(rep, ms, plain_ms, lib_ms, nb, 2 * T.real_bytes // P.element_size(),
        float(err.max()))
    segs = ", ".join(f"{d}x{d} x{c}" for _, _, c, d in T.desc.tolist())
    log(f"  block_mv {label} segments ({segs}) of {tuple(P.shape)} "
        f"{str(P.dtype)[6:]}: max|d|={float(err.max()):.3e} rel={worst:.2e},"
        f" = block_mv on the padded table | kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f}, bmm {lib_ms:.4f}, block_mv padded {pad_ms:.4f}; "
        f"streams {T.real_bytes / 1e6:.2f} MB (padded {nbytes(P) / 1e6:.2f}"
        f" MB), bound {nb / HBM_BYTES_PER_S * 1e3:.4f}")
    return nbytes(P), T.real_bytes


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


def check_edges(torch, bm, lm):
    """The hand-written kernels at the edges of their CTA stretches:

    * kernels 1 (f32 and bf16) and 2 on ``EDGE_UNSPLIT``, within 1e-5 of
      sum_j |a_ij x_j| of their plain versions and BITWISE against kernels
      5 and 6 at k = 2 and 4; kernel 3 there, each output BITWISE equal to
      kernel 1 on its (table, vector) pair and within 2e-6 of sum_j |a_ij
      x_j| of its plain version; a table off a 16-byte boundary refused;
    * the segment entry on ``EDGE_SEGMENTS`` (f32 and bf16), EQUAL to
      ``block_mv`` on the padded table and within 1e-5 of its plain
      version;
    * the split-k kernels on ``EDGE_SPLITK``: kernels 5 (f32 and bf16), 6
      and 7 at k = 2, 4, 8, BITWISE against ``block_mv`` / ``block_mv2`` /
      ``block_mv_comp`` on the unsplit table, kernels 5 and 6 within 1e-5
      of sum_j |a_ij x_j| of their plain versions, kernel 7 within 1e-12 of
      the row scale of the f64 product;
    * kernel 8 on ``EDGE_LOCAL`` in both types, on views that start 0, 4,
      8 or 12 bytes past a 16-byte boundary, within 2e-6 (f32) or 1e-13
      (f64) of sum_j |a_ij u_j| of its plain version."""
    import numpy as np

    def row_scale(A, x):
        return torch.einsum("bmk,bk->bm", A.double().abs(),
                            x.double().abs()).clamp_min(1e-300)

    rng = np.random.default_rng(5)
    rng_ds = np.random.default_rng(6)  # x of kernel 3, apart from the rest
    n1 = n2 = n3 = 0
    for nblk, m, kk in EDGE_UNSPLIT:
        A64 = torch.as_tensor(rng.standard_normal((nblk, m, kk)),
                              device="cuda")
        hi, lo = bm.split_f64(A64)
        x = torch.as_tensor(rng.standard_normal((nblk, kk)),
                            device="cuda").float()
        scale = row_scale(A64, x)
        for A in (hi, hi.to(torch.bfloat16)):
            y = bm.block_mv(A, x)
            d = (y - bm.block_mv_plain(A, x)).abs().double()
            label = f"block_mv {(nblk, m, kk)} {str(A.dtype)[6:]}"
            check(float((d / scale).max()) <= 1e-5,
                  f"{label}: beyond 1e-5 of sum|a x|")
            for k in (2, 4):
                check(torch.equal(y, bm.block_mv_splitk(
                    bm.pack_splitk(A, k, 4), x, 4)),
                    f"{label}: not bitwise equal to block_mv_splitk k={k}")
            n1 += 1
        y = bm.block_mv2(hi, lo, x)
        d = (y - bm.block_mv2_plain(hi, lo, x)).abs().double()
        label = f"block_mv2 {(nblk, m, kk)}"
        check(float((d / scale).max()) <= 1e-5,
              f"{label}: beyond 1e-5 of sum|a x|")
        for k in (2, 4):
            check(torch.equal(y, bm.block_mv2_splitk(
                bm.pack_splitk(hi, k, 4), bm.pack_splitk(lo, k, 4), x, 4)),
                f"{label}: not bitwise equal to block_mv2_splitk k={k}")
        n2 += 1
        xs = bm.split_f64(torch.as_tensor(rng_ds.standard_normal((nblk, kk)),
                                          device="cuda"))
        got = bm.block_mv_ds(hi, lo, *xs)
        ref = bm.block_mv_ds_plain(hi, lo, *xs)
        label = f"block_mv_ds {(nblk, m, kk)}"
        scale = row_scale(A64, xs[0])
        for y, (A, xv), r in zip(got, ((hi, xs[0]), (hi, xs[1]), (lo, xs[0])),
                                 ref):
            check(torch.equal(y, bm.block_mv(A, xv)),
                  f"{label}: not bitwise equal to block_mv on its pair")
            worst = float(((y - r).abs().double() / scale).max())
            check(worst <= 2e-6, f"{label}: {worst:.2e} > 2e-6 of sum|a x|")
        n3 += 1
    flat = torch.zeros(1 + 6 * 8 * 8, device="cuda")
    view = flat[1:].view(6, 8, 8)  # 4 bytes past a 16-byte boundary
    x = torch.zeros((6, 8), device="cuda")
    for call in (lambda: bm.block_mv(view, x),
                 lambda: bm.block_mv2(view, view, x),
                 lambda: bm.block_mv_ds(view, view, x, x)):
        try:
            call()
        except ValueError:
            continue
        raise Fail("a table off a 16-byte boundary was not refused")
    segs, width = EDGE_SEGMENTS
    nblk = sum(c for c, _ in segs) + 2
    for dt in (torch.float32, torch.bfloat16):
        T = bm.pack_segments(
            [torch.as_tensor(rng.standard_normal((c, d, d))) for c, d in segs],
            nblk, width, dt, "cuda")
        x = torch.as_tensor(rng.standard_normal((nblk, width)),
                            device="cuda").float()
        y = bm.block_mv_segments(T, x)
        P = T.padded()
        d = (y - bm.block_mv_segments_plain(T, x)).abs().double()
        check(torch.equal(y, bm.block_mv(P, x)),
              f"block_mv_segments {str(dt)[6:]}: differs from block_mv on "
              "the padded table")
        check(float((d / row_scale(P, x)).max()) <= 1e-5,
              f"block_mv_segments {str(dt)[6:]}: beyond 1e-5 of sum|a x|")
    n5 = n6 = n7 = 0
    for nblk, m, kk, tile in EDGE_SPLITK:
        A64 = torch.as_tensor(rng.standard_normal((nblk, m, kk)),
                              device="cuda")
        x64 = torch.as_tensor(rng.standard_normal((nblk, kk)), device="cuda")
        hi, lo = bm.split_f64(A64)
        xs = bm.split_f64(x64)
        unsplit = bm.block_mv_comp(hi, lo, *xs)
        x = xs[0]
        mv = {}
        for dt in (torch.float32, torch.bfloat16):
            A = hi.to(dt)
            mv[dt] = (A, bm.block_mv(A, x), row_scale(A, x))
        unsplit2 = bm.block_mv2(hi, lo, x)
        scale2 = row_scale(A64, x)
        for k in (2, 4, 8):
            where = f"{(nblk, m, kk)} tile {tile} k={k}"
            for dt, (A, want, scale) in mv.items():
                subs = bm.pack_splitk(A, k, tile)
                y = bm.block_mv_splitk(subs, x, tile)
                d = (y - bm.block_mv_splitk_plain(subs, x, tile)).abs()
                torch.cuda.synchronize()
                label = f"block_mv_splitk {str(dt)[6:]} {where}"
                check(torch.equal(y, want),
                      f"{label}: not bitwise equal to block_mv")
                worst = float((d.double() / scale).max())
                check(worst <= 1e-5, f"{label}: {worst:.2e} > 1e-5 of "
                      "sum|a x|")
                n5 += 1
            hs, ls = bm.pack_splitk(hi, k, tile), bm.pack_splitk(lo, k, tile)
            y = bm.block_mv2_splitk(hs, ls, x, tile)
            d = (y - bm.block_mv2_splitk_plain(hs, ls, x, tile)).abs()
            torch.cuda.synchronize()
            label = f"block_mv2_splitk {where}"
            check(torch.equal(y, unsplit2),
                  f"{label}: not bitwise equal to block_mv2")
            worst = float((d.double() / scale2).max())
            check(worst <= 1e-5, f"{label}: {worst:.2e} > 1e-5 of sum|a x|")
            n6 += 1
            got = bm.block_mv_comp_splitk(hs, ls, *xs, tile)
            ref = bm.block_mv_comp_splitk_plain(hs, ls, *xs, tile)
            torch.cuda.synchronize()
            label = f"block_mv_comp_splitk {(nblk, m, kk)} tile {tile} k={k}"
            check(all(torch.equal(a, b) for a, b in zip(got, unsplit)),
                  f"{label}: not bitwise equal to block_mv_comp")
            comp_accuracy(torch, label, hi, lo, *xs, got, ref)
            n7 += 1
    n8 = 0
    for dt in (torch.float32, torch.float64):
        for ne, nb, off in EDGE_LOCAL:
            def view(*shape):
                n = int(np.prod(shape))
                flat = torch.as_tensor(rng.standard_normal(off + n),
                                       device="cuda").to(dt)
                return flat[off:].view(shape)

            A, u = view(ne, nb, nb), view(ne, nb)
            y = lm.batched_local_matvec(A, u)
            d = (y - lm.batched_local_matvec_plain(A, u)).abs().double()
            scale = torch.einsum("eij,ej->ei", A.double().abs(),
                                 u.double().abs()).clamp_min(1e-300)
            worst = float((d / scale).max())
            tol = 1e-13 if dt == torch.float64 else 2e-6
            check(bool(torch.isfinite(y).all()) and worst <= tol,
                  f"batched_local_matvec {(ne, nb)} {str(dt)[6:]} at "
                  f"{off * A.element_size()} bytes: {worst:.2e} > {tol:.0e}")
            n8 += 1
    log(f"[kernels] edges: block_mv on {n1} tables (f32 and bf16) and "
        f"block_mv2 on {n2} within tolerance and bitwise = split-k at k=2, "
        f"4; block_mv_ds on {n3} bitwise = block_mv on each pair; "
        "misaligned tables refused; block_mv_segments (f32 and bf16) = "
        "block_mv on the padded table; "
        f"block_mv_splitk on {n5} split tables (f32 and "
        f"bf16) bitwise = block_mv; block_mv2_splitk on {n6} bitwise = "
        f"block_mv2; block_mv_comp_splitk on {n7} bitwise = block_mv_comp; "
        f"batched_local_matvec on {n8} tables within tolerance")


def check_ds(torch, bm, timer, rep, label, A_hi, A_lo, gen):
    """``block_mv_ds`` against its plain version, each of the three
    products within 2e-6 of sum_j |a_ij x_j| and BITWISE equal to
    ``block_mv`` on its (table, vector) pair, and their f64 sum against the
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
    for g, (A, x), what in zip(got, ((A_hi, x_hi), (A_hi, x_lo),
                                     (A_lo, x_hi)), ("hh", "hl", "lh")):
        check(torch.equal(g, bm.block_mv(A, x)), f"block_mv_ds {label}: "
              f"{what} not bitwise equal to block_mv on its pair")
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
        f"rel={worst:.2e}, each = block_mv on its pair, f64 sum vs f64 "
        f"product row-rel {ds_rel:.2e} | kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f}, bmm {lib_ms:.4f}, bound "
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


def cuda_tests_phase(here):
    """[cuda-tests]: ``python -m pytest --noconftest -m cuda`` on the
    JAX-free card-test file, from the repository root; every case must
    pass (none skipped)."""
    import re

    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
           CUDA_TESTS, "-q", "-p", "no:cacheprovider"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                         timeout=900)
    secs = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    tail = lines[-1] if lines else ""
    log(f"[cuda-tests] python -m pytest --noconftest -m cuda {CUDA_TESTS}: "
        f"rc {out.returncode}, {tail} ({secs:.1f} s)")
    passed = re.search(r"(\d+) passed", tail)
    ok = (out.returncode == 0 and passed is not None
          and int(passed.group(1)) == CUDA_TEST_CASES
          and not re.search(r"failed|error|skipped|xfail|xpass", tail))
    if not ok:
        for line in (lines + out.stderr.strip().splitlines())[-60:]:
            log(f"  [cuda-tests] {line}")
    check(ok, f"[cuda-tests] expected {CUDA_TEST_CASES} passed, got: {tail}")
    return secs


def rounded_f32(torch, op):
    """``op`` with its output rounded to float32 and widened back."""
    return lambda x: op(x).to(torch.float32).to(torch.float64)


def bpcg_phase(torch, bm, lm, timer, gen, m, solver, warm):
    """[bpcg]: the model's own initial solve, ``SolveInitial(iterative=True,
    GS=True, tol=1e-8)`` with the default auxspace preconditioner (the
    skeleton preconditioner in f64, JAX model settings), on the curved f64
    model ``m`` of the main path; its iterations (held to ``BPCG_COUNTS``),
    seconds, the true f64 relative residual of the saddle system through
    the plain operators, and the relative velocity difference from the
    flagship solution ``warm``, each held to its bound.  Two f32 controls,
    the same iteration with the outputs of preA and preM, or of A, B and
    B^T, rounded to float32: the first must break the residual bound, the
    second both.  Then the two faceblock variants (additive, multicolor GS)
    on the shortened channel at maxh=0.35: kernel 8 on each of their f64
    block-inverse tables against its plain version, a solve with the
    port's own scaling k and one with the JAX package's, whose count is
    held to JAX's.  ``m.u`` and ``m.p`` are put back."""
    from navier_stokes_tpu_torch.flagship import uin
    from navier_stokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_mesh_3d,
    )
    from navier_stokes_tpu_torch.models import NavierStokesMCS
    from navier_stokes_tpu_torch.solvers.bpcg import bramble_pasciak_cg_opt

    def norm(v):
        return float(torch.linalg.norm(v))

    t_phase = time.perf_counter()
    u0, p0 = m.u, m.p
    t0 = time.perf_counter()
    pre = m._preA_for(True)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    parts = pre.parts
    log(f"[bpcg] curved GS auxspace f64 preconditioner: setup {t_setup:.1f} "
        f"s ({len(parts['groups'])} colors, coarse lambda "
        f"{parts['coarse_lambda']:.4f}, theta {parts['coarse_theta']:.4f})")
    bm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = m.SolveInitial(iterative=True, GS=True, tol=BPCG_TOL,
                         maxsteps=BPCG_MAXSTEPS)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = dict(bm.LAUNCHES)
    du, p = res.x
    true_rel = solver.true_rel(*solver.residual64(du, p))
    u_flag = m.u_bc + warm.x[0]
    d_u = norm(m.u - u_flag) / norm(u_flag)
    d_p = norm(p - warm.x[1]) / norm(warm.x[1])
    log(f"[bpcg] curved GS (maxh={MAXH}): {res.iterations} iterations to "
        f"{BPCG_TOL} (converged {res.converged}; band {BPCG_COUNTS}), solve "
        f"{t_solve:.3f} s, stokes_bpcg_time {m.stokes_bpcg_time:.3f} s, "
        f"scale_k {m.stokes_bpcg_scale_k:.6g}, "
        f"{res.iterations / t_solve:.1f} its/s; true f64 rel residual "
        f"{true_rel:.3e} (bound {BPCG_RES_BOUND:g}); velocity vs "
        f"FlagshipSolve rel {d_u:.3e} (bound {BPCG_DIFF_BOUND:g}), pressure "
        f"rel {d_p:.3e}; launches {launches}")
    finite = bool(torch.isfinite(m.u).all() and torch.isfinite(p).all())
    m.u, m.p = u0, p0

    controls = {}
    ops = (m.A, m.B, m.BT, pre, m.preM)
    for name, rounded in (("preA and preM", (3, 4)),
                          ("A, B and B^T", (0, 1, 2))):
        t0 = time.perf_counter()
        ctl = bramble_pasciak_cg_opt(
            *(rounded_f32(torch, op) if i in rounded else op
              for i, op in enumerate(ops)), solver.f_mod, solver.g_mod,
            tol=BPCG_TOL, maxsteps=2 * res.iterations + 50,
            scale_k=m.stokes_bpcg_scale_k)
        torch.cuda.synchronize()
        cu, cp = ctl.x
        controls[name] = (solver.true_rel(*solver.residual64(cu, cp)),
                          norm(m.u_bc + cu - u_flag) / norm(u_flag))
        log(f"[bpcg] f32 control ({name} outputs rounded to float32): "
            f"{ctl.iterations} iterations (converged {ctl.converged}), "
            f"{time.perf_counter() - t0:.3f} s; true f64 rel residual "
            f"{controls[name][0]:.3e}, velocity vs FlagshipSolve rel "
            f"{controls[name][1]:.3e}")

    def run():
        bramble_pasciak_cg_opt(m.A, m.B, m.BT, pre, m.preM, solver.f_mod,
                               solver.g_mod, tol=1e-30, maxsteps=50,
                               scale_k=m.stokes_bpcg_scale_k)
        torch.cuda.synchronize()

    profile_device(torch, run, "bpcg curved GS", "50 BPCG iterations")
    check(res.converged, f"[bpcg] did not converge in {BPCG_MAXSTEPS}")
    check(finite, "[bpcg] the solution is not finite")
    check(BPCG_COUNTS[0] <= res.iterations <= BPCG_COUNTS[1],
          f"[bpcg] {res.iterations} iterations, outside {BPCG_COUNTS}")
    check(true_rel <= BPCG_RES_BOUND,
          f"[bpcg] true residual {true_rel:.3e} > {BPCG_RES_BOUND:g}")
    check(d_u <= BPCG_DIFF_BOUND,
          f"[bpcg] velocity differs from FlagshipSolve's by {d_u:.3e}")
    # "not <=": a control that overflows to NaN breaks the bound too
    ctl_res, _ = controls["preA and preM"]
    check(not ctl_res <= BPCG_RES_BOUND,
          f"[bpcg] the f32-preconditioner control passes the residual bound "
          f"({ctl_res:.3e}): it cannot tell f32 preconditioners from f64")
    ctl_res, ctl_u = controls["A, B and B^T"]
    check(not ctl_res <= BPCG_RES_BOUND and not ctl_u <= BPCG_DIFF_BOUND,
          f"[bpcg] the f32-operator control passes a bound (residual "
          f"{ctl_res:.3e}, velocity {ctl_u:.3e})")

    t0 = time.perf_counter()
    mesh = channel_with_cylinder_mesh_3d(BPCG_SMALL_MAXH, length=1.2,
                                         circle_resolution=8)
    ms = NavierStokesMCS(mesh, nu=NU, inflow="inlet", outflow="outlet",
                         wall="wall|cyl", uin=uin, timestep=2e-3,
                         order=ORDER, preconditioner="faceblock",
                         device="cuda")
    log(f"[bpcg] shortened channel maxh={BPCG_SMALL_MAXH}: {mesh.ne} tets, "
        f"ndof={ms.n}+{ms.Q.ndof}, model {time.perf_counter() - t0:.1f} s")
    for gs in (False, True):
        name = "GS" if gs else "additive"
        t0 = time.perf_counter()
        pre_s = ms._preA_for(gs)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        tables = ([g[2] for g in pre_s.gs.groups] if gs else [pre_s.table])
        for i, A in enumerate(tables):
            check_local_mv(torch, lm, timer, None,
                           f"faceblock {name} inverses {i}", A, gen)
        jax_n, jax_k = BPCG_SMALL_JAX[gs]
        counts = {}
        for which, k in (("own k", None), ("JAX k", jax_k)):
            bm.reset_launches()
            t0 = time.perf_counter()
            r = ms.SolveInitial(GS=gs, tol=BPCG_TOL, maxsteps=BPCG_MAXSTEPS,
                                scale_k=k)
            torch.cuda.synchronize()
            t_s = time.perf_counter() - t0
            counts[which] = r.iterations
            log(f"[bpcg] faceblock {name} (maxh={BPCG_SMALL_MAXH}), {which} "
                f"{ms.stokes_bpcg_scale_k:.6g}: {r.iterations} iterations "
                f"(JAX package on the CPU: {jax_n} with k {jax_k:.6g}), "
                f"setup {t_pre:.1f} s, solve {t_s:.3f} s, launches "
                f"{dict(bm.LAUNCHES)}")
            check(r.converged and bool(torch.isfinite(ms.u).all()),
                  f"[bpcg] faceblock {name} did not converge ({which})")
            check(bm.LAUNCHES["batched_local_matvec_f64"] > 0,
                  f"[bpcg] faceblock {name}: kernel 8 never launched")
        off = abs(counts["JAX k"] - jax_n) / jax_n
        check(off <= BPCG_SMALL_BAND,
              f"[bpcg] faceblock {name} with the JAX k: {counts['JAX k']} "
              f"iterations, JAX {jax_n} (off {off:.1%})")
    secs = time.perf_counter() - t_phase
    log(f"[bpcg] phase {secs:.1f} s")
    return secs


def bench_phase(bench, m, m32, cold, warm, card):
    """[bench]: the port's bench line (``navier_stokes_tpu_torch.bench.
    measure``) on the models already built and the main path's cold and
    warm solves; returns the line."""
    t0 = time.perf_counter()
    line, info = bench.measure(m, m32, cold=cold, warm=warm, card=card)
    secs = time.perf_counter() - t0
    log(f"[bench] cold {info['cold'].inner} / warm {info['warm'].inner} "
        f"inner iterations (budget {bench.MAX_INNER}), warm "
        f"{info['warm'].seconds:.3f} s; {info['n_steps']} warm steps in "
        f"{info['step_seconds']:.3f} s; phase {secs:.1f} s")
    check(tuple(line) == bench.KEYS, f"[bench] keys {tuple(line)}")
    check(info["warm"].inner <= MAX_INNER,
          f"[bench] {info['warm'].inner} inner iterations > {MAX_INNER}")
    check(all(isinstance(line[k], float) and line[k] > 0
              for k in bench.KEYS if k not in ("metric", "unit")),
          f"[bench] a number is not positive: {line}")
    return line, secs


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
    solution.  Returns the launch counts of one (the cold) f32 step and of
    the first f64 step."""
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
    # is a step bitwise repeatable?  ([repeat] holds it to that)
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
    u64, counts64 = transient_steps(m64, 1, project_tol=PROJECT_TOL64,
                                    mstar_tol=MSTAR_TOL, u=u64_start)
    launches64 = dict(bm.LAUNCHES)  # the first f64 step's
    u64, more = transient_steps(m64, 2, project_tol=PROJECT_TOL64,
                                mstar_tol=MSTAR_TOL, u=u64)
    counts64 += more
    torch.cuda.synchronize()
    t64 = time.perf_counter() - t0
    check(bool(torch.isfinite(u64).all()), "[transient] f64 steps blew up")
    check(u64.dtype == torch.float64, "[transient] f64 steps lost precision")
    log(f"[transient] f64: 3 steps from the flagship solution in {t64:.3f} s "
        f"({t64 / 3 * 1e3:.1f} ms/step, the first one cold), CG counts "
        f"{counts64}, ||B u|| {norm(m64.B_raw(u64_start)):.3e} -> "
        f"{norm(m64.B_raw(u64)):.3e}, max |u3 - u0| "
        f"{float((u64 - u64_start).abs().max()):.3e}, launches of the "
        f"first step {launches64}, of all three {dict(bm.LAUNCHES)}")
    check(launches64["batched_local_matvec_f64"] > 0,
          "batched_local_matvec_f64 never launched in the first f64 step")
    check(max(c["project"] for c in counts64) < 2000,
          "the f64 projection CG ran into maxsteps")
    return launches, launches64


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

    # what a plain stream of the bench table reaches here: printed only
    sum_ms = timer(lambda: A.sum())
    sum_bound = nbytes(A) / HBM_BYTES_PER_S * 1e3
    log(f"[stream] A.sum() on the bench table ({nbytes(A) / 1e6:.1f} MB): "
        f"{sum_ms:.4f} ms, {sum_bound / sum_ms:.3f} of the {sum_bound:.4f} "
        "ms bound at 3.35 TB/s")
    check_stream_edges(torch, bm, sm)


def check_stream_edges(torch, bm, sm):
    """The edges of kernels 9 and 13, each BITWISE against ``block_mv`` (on
    a 16-byte aligned copy of the table; for 13 on the AoS table) and within
    1e-4 of the plain version; 13's padding columns zero, and its refusal
    of an element count that is no multiple of 4."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    n = 0
    for nblk, m, k in EDGE_ROWS:
        for off in (0, 1):
            flat = torch.randn(off + nblk * m * k, generator=gen,
                               device="cuda")
            xflat = torch.randn(off + nblk * k, generator=gen, device="cuda")
            A, x = flat[off:].view(nblk, m, k), xflat[off:].view(nblk, k)
            ref, want = bm.block_mv(A.clone(), x), bm.block_mv_plain(A, x)
            for rows in EDGE_ROWS_R:
                y = sm.block_mv_rows(A, x, rows)
                torch.cuda.synchronize()
                err = float((y - want).abs().max())
                check(torch.equal(y, ref) and err <= 1e-4,
                      f"block_mv_rows {(nblk, m, k)} view +{off} rows={rows}:"
                      f" not bitwise equal to block_mv, or {err:.2e} > 1e-4")
                n += 1
    for nb in EDGE_SOA_NB:
        for ne in EDGE_SOA_NE:
            real = ne - 3 if ne > 4 else ne  # the rest: zero padding
            A2 = torch.zeros((nb, nb, ne), device="cuda")
            A2[:, :, :real] = torch.randn((nb, nb, real), generator=gen,
                                          device="cuda")
            uT = torch.zeros((nb, ne), device="cuda")
            uT[:, :real] = torch.randn((nb, real), generator=gen,
                                       device="cuda")
            y = sm.block_mv_soa(A2, uT)
            torch.cuda.synchronize()
            ref = bm.block_mv(A2.permute(2, 0, 1).contiguous(),
                              uT.T.contiguous())
            err = float((y - sm.block_mv_soa_plain(A2, uT)).abs().max())
            check(torch.equal(y.T, ref) and err <= 1e-4,
                  f"block_mv_soa nb={nb} ne={ne}: not bitwise equal to "
                  f"block_mv on the AoS table, or {err:.2e} > 1e-4")
            check(real == ne or float(y[:, real:].abs().max()) == 0.0,
                  f"block_mv_soa nb={nb} ne={ne}: padding columns non-zero")
            n += 1
    try:
        sm.block_mv_soa(torch.zeros((7, 7, 333), device="cuda"),
                        torch.zeros((7, 333), device="cuda"))
        refused = False
    except ValueError:
        refused = True
    check(refused, "block_mv_soa took ne=333: its tensor maps need ne % 4 "
          "== 0")
    log(f"[kernels] edges of block_mv_rows and block_mv_soa: {n} cases "
        "bitwise = block_mv, ne=333 refused")


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
    for r in rows:
        check(r["kernel"] != "block_mv_splitk" or r["bitwise"],
              f"[microbench] {r['label']}: not bitwise equal to block_mv")
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


def repeat_phase(torch, m, step):
    """[repeat]: two f32 SIMPLE steps of the MCS stepping model ``m`` from
    its state must give bitwise equal increments (every scatter of the
    step goes through a deterministic ``ScatterPlan``), with equal CG
    counts."""
    t0 = time.perf_counter()
    u0 = m.u
    u1 = step(u0)
    c1 = dict(m.last_iterations)
    u2 = step(u0)
    c2 = dict(m.last_iterations)
    torch.cuda.synchronize()
    same = torch.equal(u1 - u0, u2 - u0)
    log(f"[repeat] MCS f32 step twice from the same state: increments "
        f"{'bitwise equal' if same else 'DIFFERENT'}, max |d| "
        f"{float((u1 - u2).abs().max()):.3e} (max |u1 - u0| "
        f"{float((u1 - u0).abs().max()):.3e}), CG counts {c1} / {c2} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(same, "[repeat] two f32 steps from the same state differ")
    check(c1 == c2, f"[repeat] CG counts differ: {c1} / {c2}")
    return time.perf_counter() - t0


def refine_phase(torch, bm, solver):
    """[refine]: ``mixed_precision_minres_refinement_2phase`` to 1e-8 on the
    main path's model and its ``equilibrated_f32_ops(gs=True)`` (phase 1:
    block_mv2 on A32/B32/BT32, block_mv on the preconditioner's tables),
    twice: with ``ops64`` the model's native f64 A / B / B^T, as the JAX
    package's CPU path, and with ``ops64`` built from the compensated
    double-single kernel (block_mv_comp, the TPU bench's substitute),
    wrapped back to the unscaled system and held to the native operators
    within 1e-12 relative first.  Per run: passes, inner iterations, the
    true f64 relative residual (<= 1.01e-8, finite), wall seconds and the
    launches."""
    from navier_stokes_tpu_torch.solvers.refinement import (
        mixed_precision_minres_refinement_2phase,
    )

    t_phase = time.perf_counter()
    m, D, ods = solver.m, solver.D, solver.ops_ds
    Dinv = 1.0 / D
    native = dict(A=m.A, B=m.B, BT=m.BT)
    comp = dict(A=lambda u: Dinv * ods["A"](Dinv * u),
                B=lambda u: ods["B"](Dinv * u),
                BT=lambda p: Dinv * ods["BT"](p))
    gen = torch.Generator(device="cuda").manual_seed(5)
    u = torch.randn(m.n, generator=gen, device="cuda", dtype=torch.float64)
    p = torch.randn(m.Q.ndof, generator=gen, device="cuda",
                    dtype=torch.float64)
    for name, x in (("A", u), ("B", u), ("BT", p)):
        want, got = native[name](x), comp[name](x)
        rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        log(f"[refine] compensated {name} wrapped to the unscaled system: "
            f"{rel:.3e} relative to the native f64 operator")
        check(rel <= 1e-12, f"[refine] the compensated {name} is {rel:.3e} "
              "off the native f64 operator")
    results = {}
    for label, ops64 in (("native f64", native),
                         ("compensated (block_mv_comp)", comp)):
        bm.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (x0, x1), r, (p1, p2), inner = \
            mixed_precision_minres_refinement_2phase(
                ops64, solver.ops32, D, solver.f_mod, solver.g_mod, tol=TOL)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(bm.LAUNCHES)
        true_rel = solver.true_rel(*solver.residual64(x0, x1))
        results[label] = (p1, p2, inner, true_rel, secs)
        log(f"[refine] 2-phase, ops64 {label}: passes ({p1}, {p2}), inner "
            f"{inner}, driver rel {r:.3e}, true f64 rel {true_rel:.3e}, "
            f"{secs:.3f} s (FlagshipSolve: 358 inner to 9.152e-10); "
            f"launches {launches}")
        check(true_rel <= 1.01 * TOL and math.isfinite(true_rel),
              f"[refine] {label}: true residual {true_rel:.3e}")
        check(bool(torch.isfinite(x0).all() and torch.isfinite(x1).all()),
              f"[refine] {label}: the solution is not finite")
        for name in ("block_mv", "block_mv2"):
            check(launches.get(name, 0) > 0,
                  f"[refine] {label}: {name} never launched")
    check(bm.LAUNCHES.get("block_mv_comp", 0) > 0,
          "[refine] the compensated run never launched block_mv_comp")
    secs = time.perf_counter() - t_phase
    log(f"[refine] phase {secs:.1f} s")
    return secs


def hdg_true_rel(torch, m):
    """The true relative residual of the HDG model's initial Stokes system
    at its state (u, p), through its f64 operators."""
    f_mod = torch.where(m.free, m.f - m.A_raw(m.u_bc), 0.0)
    g_mod = -m.B_raw(m.u_bc)
    du = m.u - m.u_bc
    r0 = f_mod - m.A(du) - m.BT(m.p)
    r1 = g_mod - m.B(du)
    return float(torch.sqrt(torch.dot(r0, r0) + torch.dot(r1, r1))
                 / torch.sqrt(torch.dot(f_mod, f_mod)
                              + torch.dot(g_mod, g_mod)))


def hdg3d_phase(torch, bm, lm, timer, gen, reports):
    """[hdg3d]: ``NavierStokesHDG3D`` at the demo's configuration (the
    reference's NavierStokesSIMPLE_test_3D.py through
    scripts/navier_stokes_3d.py --hdg: the straight channel at
    ``HDG_MAXH``, order 2, nu = 1e-3, dt = 2e-3, auxspace preconditioner):
    setup by part; kernel 8 on each f64 table it launches (A, M, the
    vertex-star inverses) against its plain version; ``SolveInitial(tol=
    1e-8)`` (iterations, seconds, true f64 residual <= 1.01e-8);
    ``Project`` (||B u|| < 1e-7); two steps from the same state bitwise
    equal ([repeat]); 3 ``DoTimeStep``s (finite; steps/s, CG counts);
    then an f32 twin, kernel 8 (f32) and kernel 1 on its tables, and
    ``solve_initial_refined`` (the guard: a finite result whose residual
    is below the start's).  Launches per BPCG iteration and per step.
    Returns (seconds, launches of the f64 path, launches of the refined
    run)."""
    from navier_stokes_tpu_torch.flagship import uin
    from navier_stokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_mesh_3d,
    )
    from navier_stokes_tpu_torch.models import NavierStokesHDG3D
    from navier_stokes_tpu_torch.solvers.refinement import (
        solve_initial_refined,
    )

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    mesh = channel_with_cylinder_mesh_3d(HDG_MAXH)
    t_mesh = time.perf_counter() - t0
    kw = dict(nu=NU, inflow="inlet", outflow="outlet", wall="wall|cyl",
              uin=uin, timestep=2e-3, order=ORDER, device="cuda")
    cache = {}
    t0 = time.perf_counter()
    m = NavierStokesHDG3D(mesh, assembly_cache=cache, **kw)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    T = m.preA.table
    nblk, bmax, _ = T.shape
    log(f"[hdg3d] maxh={HDG_MAXH}: {mesh.ne} tets, {mesh.nv} vertices, "
        f"ndof={m.n}+{m.Q.ndof}; mesh {t_mesh:.1f} s, model {t_model:.1f} "
        "s: " + ", ".join(f"{k} {v:.1f} s" for k, v in
                          m.setup_seconds.items())
        + f"; vertex-star inverses {nblk} x {bmax} x {bmax} f64 "
        f"({nbytes(T) / 1e9:.2f} GB padded), device memory peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    check(bool(torch.isfinite(T).all()), "[hdg3d] non-finite block inverse")
    rep64 = reports["batched_local_matvec_f64_hdg3d"]
    for tname, A in (("A", m.A_loc), ("M", m.M_loc),
                     ("vertex-star inverses", T)):
        check_local_mv(torch, lm, timer, rep64, f"hdg3d {tname}", A, gen)

    bm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = m.SolveInitial(iterative=True, tol=TOL, maxsteps=HDG_MAXSTEPS)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    solve_launches = dict(bm.LAUNCHES)
    true_rel = hdg_true_rel(torch, m)
    per_it = {k: round(v / max(res.iterations, 1), 2)
              for k, v in solve_launches.items() if v}
    log(f"[hdg3d] SolveInitial(tol={TOL:g}): {res.iterations} BPCG "
        f"iterations (converged {res.converged}), {t_solve:.3f} s "
        f"(stokes_bpcg_time {m.stokes_bpcg_time:.3f} s, "
        f"{1e3 * t_solve / max(res.iterations, 1):.2f} ms per iteration), "
        f"scale_k {m.stokes_bpcg_scale_k:.6g}; true f64 rel residual "
        f"{true_rel:.3e}; launches {solve_launches}, per iteration {per_it}")
    check(res.converged, f"[hdg3d] BPCG did not converge in {HDG_MAXSTEPS}")
    check(true_rel <= 1.01 * TOL, f"[hdg3d] true residual {true_rel:.3e}")
    check(solve_launches.get("batched_local_matvec_f64", 0) > 0,
          "[hdg3d] kernel 8 never launched in the solve")

    t0 = time.perf_counter()
    bu0 = float(torch.linalg.norm(m.B_raw(m.u)))
    m.Project()
    torch.cuda.synchronize()
    bu = float(torch.linalg.norm(m.B_raw(m.u)))
    log(f"[hdg3d] Project: ||B u|| {bu0:.3e} -> {bu:.3e}, projection CG "
        f"{m.last_iterations['project']}, {time.perf_counter() - t0:.3f} s "
        f"(Chebyshev setup {m.setup_seconds.get('mass chebyshev', 0):.1f} "
        "s)")
    check(bu < 1e-7, f"[hdg3d] ||B u|| = {bu:.3e} after Project")

    t0 = time.perf_counter()
    step = m.make_step_fn()
    torch.cuda.synchronize()
    log(f"[hdg3d] step setup {time.perf_counter() - t0:.1f} s (convection "
        f"{m.setup_seconds.get('convection', 0):.1f} s)")
    u0 = m.u
    u1 = step(u0)
    c1 = dict(m.last_iterations)
    u2 = step(u0)
    torch.cuda.synchronize()
    same = torch.equal(u1 - u0, u2 - u0)
    log(f"[repeat] HDG3D f64 step twice from the same state: increments "
        f"{'bitwise equal' if same else 'DIFFERENT'}, max |d| "
        f"{float((u1 - u2).abs().max()):.3e} (max |u1 - u0| "
        f"{float((u1 - u0).abs().max()):.3e}), CG counts {c1} / "
        f"{dict(m.last_iterations)}")
    check(same, "[repeat] two HDG3D steps from the same state differ")
    del u1, u2

    counts = []
    bm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        m.DoTimeStep()
        counts.append(dict(m.last_iterations))
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    step_launches = dict(bm.LAUNCHES)
    path_launches = {k: solve_launches.get(k, 0) + step_launches.get(k, 0)
                     for k in set(solve_launches) | set(step_launches)}
    finite = bool(torch.isfinite(m.u).all())
    log(f"[hdg3d] 3 DoTimeSteps in {t_steps:.3f} s ({3 / t_steps:.3f} "
        f"steps/s), CG counts {counts}, max |u| {float(m.u.abs().max()):.4f}"
        f", ||B u|| {float(torch.linalg.norm(m.B_raw(m.u))):.3e}; launches "
        f"per step {dict((k, v / 3) for k, v in step_launches.items() if v)}")
    check(finite, "[hdg3d] the steps blew up")
    check(max(c["project"] for c in counts) < 2000
          and max(c["mstar"] for c in counts) < 2000,
          "[hdg3d] a CG ran into maxsteps")

    # the f32 twin and the mixed-precision initial solve
    t0 = time.perf_counter()
    m32 = NavierStokesHDG3D(mesh, assembly_cache=cache, dtype=torch.float32,
                            **kw)
    torch.cuda.synchronize()
    log(f"[hdg3d] f32 twin: {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in m32.setup_seconds.items())
        + f"), device memory peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    check_local_mv(torch, lm, timer, reports["batched_local_matvec_hdg3d"],
                   "hdg3d f32 A", m32.A_loc, gen)
    check_block_mv(torch, bm, timer, reports["block_mv_hdg3d"],
                   "hdg3d f32 vertex-star inverses", m32.preA.table, gen)
    bm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r, passes, inner = solve_initial_refined(m, m32, tol=TOL)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    ref_launches = dict(bm.LAUNCHES)
    true_ref = hdg_true_rel(torch, m)
    log(f"[hdg3d] solve_initial_refined (f32 BPCG inner, tol {TOL:g}): "
        f"passes {passes}, inner {inner}, driver rel {r:.3e}, true f64 rel "
        f"{true_ref:.3e}, {t_ref:.3f} s; launches {ref_launches}")
    check(math.isfinite(r) and r < 1.0 and bool(torch.isfinite(m.u).all()),
          f"[hdg3d] the refinement guard failed: rel {r}")
    check(abs(true_ref - r) <= 1e-3 * r + 1e-15,
          f"[hdg3d] the driver's residual {r:.3e} is not the true one "
          f"{true_ref:.3e}")
    for name in ("block_mv", "batched_local_matvec",
                 "batched_local_matvec_f64"):
        check(ref_launches.get(name, 0) > 0,
              f"[hdg3d] {name} never launched in the refined solve")
    del m, m32, T, cache
    secs = time.perf_counter() - t_phase
    log(f"[hdg3d] phase {secs:.1f} s")
    return secs, path_launches, ref_launches


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
        done = REDESIGNED.get(e["name"])
        log(f"[redesign] {e['name']:24s} {e['ms'] / e['library_ms']:.3f} x "
            f"the library call ({e['ms']:.4f} against {e['library_ms']:.4f} "
            f"ms), bound {e['bound_ms']:.4f}; {e['launches']} launches x "
            f"{(e['ms'] - e['bound_ms']) / reports[e['name']].n:.4f} ms over "
            f"the bound = {lost:.1f} ms on its path"
            + (f" (redesigned: {done})" if done else ""))


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
    from navier_stokes_tpu_torch import bench
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
    from navier_stokes_tpu_torch.utils.timers import KernelTimer

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
    card = bench.card_name()
    log(f"[card] {card}")

    # 2. the card-only tests, from the repository alone (no JAX)
    t_cuda_tests = cuda_tests_phase(here)

    # 3. setup: the main path (curved, GS) and slice 1's (straight, additive)
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

    # 4. kernel checks on the main path's tables (and slice 1's)
    timer = KernelTimer()
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
        "batched_local_matvec_f64": KernelReport(
            "batched_local_matvec_f64", f"{PALLAS_LOCAL}:26", SRC_LOCAL,
            F64_FLOPS_PER_S),
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
        # the 3D HDG model's tables ([hdg3d]): kernel 8 on its element and
        # vertex-star tables, kernel 1 on its f32 twin's vertex stars
        "batched_local_matvec_f64_hdg3d": KernelReport(
            "batched_local_matvec_f64_hdg3d", f"{PALLAS_LOCAL}:26", SRC_LOCAL,
            F64_FLOPS_PER_S),
        "batched_local_matvec_hdg3d": KernelReport(
            "batched_local_matvec_hdg3d", f"{PALLAS_LOCAL}:26", SRC_LOCAL),
        "block_mv_hdg3d": KernelReport("block_mv_hdg3d", f"{PALLAS}:118"),
    }
    for label, s, keep in (("curved GS (main path)", solver, True),
                           ("straight additive", solver_s, False)):
        o32, ods = s.ops32, s.ops_ds

        def rep(name):
            return reports[name] if keep else None

        log(f"[kernels] {label}: block_mv on every table of one preA apply")
        padded = real = 0
        for tname, A in o32["preA"].parts["tables"].items():
            if isinstance(A, bm.SegmentTable):
                p_, r_ = check_block_mv_segments(torch, bm, timer,
                                                 rep("block_mv"), tname, A,
                                                 gen)
                padded, real = padded + p_, real + r_
            else:
                check_block_mv(torch, bm, timer, rep("block_mv"), tname, A,
                               gen)
        if real:
            log(f"[kernels] {label}: the GS solve tables stream "
                f"{real / 1e6:.1f} MB per sweep direction by segment; padded "
                f"they would hold {padded / 1e6:.1f} MB")
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

    check_edges(torch, bm, lm)
    log("[kernels] batched_local_matvec on the transient step's tables "
        "(f32: the stepping model's; f64: the model's own)")
    for mm, name in ((m32, "batched_local_matvec"),
                     (m, "batched_local_matvec_f64")):
        pre2 = mm._pre_proj_twolevel()
        for tname, A in (("M_loc", mm._M_loc), ("A_cond", mm._A_cond),
                         ("S_inv", pre2.S_inv)):
            check_local_mv(torch, lm, timer, reports[name], tname, A, gen)
    log("[kernels] block_mv_ds on the split A, B, BT tables")
    for tname, op in (("A_ds", ods["A"]), ("B_ds", ods["B"]),
                      ("BT_ds", ods["BT"])):
        check_ds(torch, bm, timer, reports["block_mv_ds"], tname, *op.tables,
                 gen)

    check_stream(torch, bm, sm, timer, reports)

    # 5. main path: the curved GS solve, cold then warm
    cold, launches = solve_and_check(torch, bm, solver, "curved GS cold",
                                     MAX_INNER)
    for name in ("block_mv", "block_mv2", "block_mv_comp"):
        check(launches.get(name, 0) > 0, f"{name} never launched on the "
              "main path")
    warm, _ = solve_and_check(torch, bm, solver, "curved GS warm", MAX_INNER)

    # 6. slice 1's path: straight additive, cold, warm, phase-2 polish
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

    # 7. split-k path on the curved model
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

    # 8. per-apply milliseconds (bench.py probe_ops)
    apply_probes(torch, "curved GS", solver)
    apply_probes(torch, f"split_k={SPLIT_K}", solver_k)
    apply_probes(torch, "straight additive", solver_s)

    # 9. where a phase-1 iteration's time goes
    profile_minres(torch, solver, "curved GS")
    profile_minres(torch, solver_s, "straight additive")

    # 10. the plain double-single residual of the converged solution
    launches_ds = ds_phase(torch, bm, solver, warm)

    # 11. the model's own BPCG initial solve (no kernel on its path)
    t_bpcg = bpcg_phase(torch, bm, lm, timer, gen, m, solver, warm)

    # 12. the transient step: f32 as bench.py, then f64 from the solution
    launches_t, launches_t64 = transient_phase(torch, bm, m32, step32, m,
                                               m.u_bc + warm.x[0])

    # 12b. the repeatability of the f32 step (every scatter deterministic)
    t_repeat = repeat_phase(torch, m32, step32)

    # 13. the port's bench line on the models already built
    bench_line, t_bench = bench_phase(bench, m, m32, cold, warm, card)

    # 13b. the 2-phase MINRES refinement driver on the main path's model
    t_refine = refine_phase(torch, bm, solver)

    # 14. this slice's path: the two ported microbenchmark scripts
    launches_mb = microbench_phase(bm)

    # 15. the SA-AMG coarse solve on a mesh above the dense limit
    amg_phase(torch, bm, build_model, FlagshipSolve, cylinder_geometry)

    # 16. the 3D HDG model: the models of the MCS paths are let go first
    del solver, solver_s, solver_k, m_s, step32, m32, m
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t_hdg, launches_hdg, launches_ref = hdg3d_phase(torch, bm, lm, timer, gen,
                                                    reports)

    counts = {**{k: launches[k] for k in ("block_mv", "block_mv2",
                                          "block_mv_comp")},
              **{k: launches_k[k] for k in ("block_mv_splitk",
                                            "block_mv2_splitk",
                                            "block_mv_comp_splitk")},
              "block_mv_ds": launches_ds,
              "batched_local_matvec": launches_t["batched_local_matvec"],
              "batched_local_matvec_f64":
                  launches_t64["batched_local_matvec_f64"],
              **{k: launches_mb[k] for k in ("block_mv_rows", "block_mv_mega",
                                             "block_mv_ring",
                                             "block_mv_soa")},
              "block_mv_splitk_seq": launches_mb["block_mv_splitk"],
              "batched_local_matvec_f64_hdg3d":
                  launches_hdg.get("batched_local_matvec_f64", 0),
              "batched_local_matvec_hdg3d":
                  launches_ref.get("batched_local_matvec", 0),
              "block_mv_hdg3d": launches_ref.get("block_mv", 0)}
    kernels = {"kernels": [rep.entry(counts[name])
                           for name, rep in reports.items()]}
    redesign_order(kernels["kernels"], reports)
    log(f"[time] phases: cuda-tests {t_cuda_tests:.1f} s, bpcg "
        f"{t_bpcg:.1f} s, bench {t_bench:.1f} s; new: repeat "
        f"{t_repeat:.1f} s, refine {t_refine:.1f} s, hdg3d {t_hdg:.1f} s "
        f"(together {t_repeat + t_refine + t_hdg:.1f} s); whole run "
        f"{time.perf_counter() - T_START:.1f} s")
    print(json.dumps(bench_line), flush=True)
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

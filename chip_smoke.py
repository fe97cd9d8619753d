#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``navier_stokes_tpu_torch``) on one GPU.

Drives the port's paths -- the initial Stokes solve of the 3D MCS channel
with cylinder at maxh=0.09, order 2, nu=1e-3, to a true f64 relative
residual of 1e-8 -- in phases; any failed phase ends the run with a
non-zero exit:

1. build: compile ``navier_stokes_tpu_torch/csrc/block_mv.cu`` with nvcc
   (sm_90a) and print the build seconds and the card;
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
   configuration and the kernels that take most of it.

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
REPS = 25
SRC = "navier_stokes_tpu_torch/csrc/block_mv.cu"
PALLAS = "navier_stokes_tpu/ops/pallas_mv.py"


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


# -- timing -------------------------------------------------------------------


class Timer:
    """Median time of one call on the card, from CUDA events around each
    call, with the 50 MB L2 cache flushed before every call (on the main
    path every table arrives cold: the others stream through in between)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                 device="cuda")  # 256 MB

    def __call__(self, fn, reps=REPS):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        evs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in evs)


def per_apply_ms(torch, fn, x, k=20):
    """Milliseconds per apply over a run of k back-to-back applies (the
    solve's own steady state, host launch gaps included)."""
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(k):
        fn(x)
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / k


# -- kernel checks --------------------------------------------------------------


class KernelReport:
    """Sums one kernel's checks over the shapes of the main path."""

    def __init__(self, name, replaces):
        self.name, self.replaces = name, replaces
        self.ms = self.plain_ms = self.library_ms = 0.0
        self.bytes = self.flops = 0
        self.max_abs_err = 0.0

    def add(self, ms, plain_ms, library_ms, nbytes, flops, err):
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
            "name": self.name, "route": "cuda", "source": SRC,
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
    """Device busy share of phase-1 MINRES: the card's kernel time under
    torch.profiler over the wall time of the same call run unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from navier_stokes_tpu_torch.solvers.minres import minres

    f32 = torch.float32
    rhs = ((solver.D * solver.f_mod).to(f32), solver.g_mod.to(f32))

    def run():
        minres(solver.K32, rhs, pre=solver.pre32, maxsteps=steps, tol=1e-30,
               abs_test=False)
        torch.cuda.synchronize()

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
        log(f"[profile {label}] {steps} MINRES iterations: wall "
            f"{wall_ms:.2f} ms; device time not measured (the profiler saw "
            "no device time)")
        return
    log(f"[profile {label}] {steps} MINRES iterations: wall {wall_ms:.2f} ms "
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
        log(f"[apply {label}] {name:22s} {per_apply_ms(torch, fn, x):.4f} ms")


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")

    # 1. build
    t0 = time.perf_counter()
    path, secs = bm.build_library(verbose=True)
    bm.load_library()
    log(f"[build] {path.name}: nvcc {secs:.1f} s "
        f"(with load {time.perf_counter() - t0:.1f} s)")
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
    m = build_model(MAXH, order=ORDER, nu=NU, device="cuda", mesh=mesh,
                    geometry=geo)
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

    # 3. kernel checks on the main path's tables (and slice 1's)
    timer = Timer(torch)
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

    counts = {**{k: launches[k] for k in ("block_mv", "block_mv2",
                                          "block_mv_comp")},
              **{k: launches_k[k] for k in ("block_mv_splitk",
                                            "block_mv2_splitk",
                                            "block_mv_comp_splitk")}}
    kernels = {"kernels": [rep.entry(counts[name])
                           for name, rep in reports.items()]}
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

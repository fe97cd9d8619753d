#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``navier_stokes_tpu_torch``) on one GPU.

Drives the port's main path -- the initial Stokes solve of the 3D MCS channel
with cylinder at maxh=0.09, order 2, nu=1e-3, straight geometry, additive
skeleton preconditioner -- to a true f64 relative residual of 1e-8, in
phases; any failed phase ends the run with a non-zero exit:

1. build: compile ``navier_stokes_tpu_torch/csrc/block_mv.cu`` with nvcc
   (sm_90a) and print the build seconds and the card;
2. setup: mesh, model and the equilibrated operators, seconds per phase;
3. kernel checks: every kernel wrapper on the main path's own device tables
   (and on an engineered cancellation case) against its plain PyTorch
   version on the same inputs, within the stated bounds, with its median
   time, its byte bound, the plain version's time and one PyTorch library
   call's time as a yardstick;
4. main path: launch counters set to 0, ``FlagshipSolve.full_solve`` cold,
   counters read; every kernel must have launched; then a warm solve; the
   true-f64 residual of each must be <= 1.01e-8; then phase 2 alone
   polishes the warm solution to 1e-10 (phase 1 already meets 1e-8 here);
5. per-apply milliseconds of A32, BT32*B32, preA32, A_ds and residual_pass
   (bench.py's probe_ops, timed with CUDA events);
6. profile: the device busy share of 100 phase-1 MINRES iterations
   (torch.profiler kernel time over unprofiled wall time) and the kernels
   that take most of it.

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
REPS = 25


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
            "name": self.name, "route": "cuda",
            "source": "navier_stokes_tpu_torch/csrc/block_mv.cu",
            "replaces": self.replaces, "launches": int(launches),
            "max_abs_err": float(self.max_abs_err), "ms": self.ms,
            "plain_ms": self.plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": self.library_ms,
        }


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


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
    rep.add(ms, plain_ms, lib_ms, nbytes(A, x, y), 2 * A.numel(),
            float(err.max()))
    log(f"  block_mv {label} {tuple(A.shape)} {str(A.dtype)[6:]}: "
        f"max|d|={float(err.max()):.3e} rel={worst:.2e} | kernel {ms:.4f} ms"
        f", plain {plain_ms:.4f}, bmm {lib_ms:.4f}, bound "
        f"{nbytes(A, x, y) / HBM_BYTES_PER_S * 1e3:.4f}")


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
    rep.add(ms, plain_ms, lib_ms, nbytes(A_hi, A_lo, x, y),
            4 * A_hi.numel(), float(err.max()))
    log(f"  block_mv2 {label} {tuple(A_hi.shape)}: max|d|="
        f"{float(err.max()):.3e} rel={worst:.2e} | kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f}, bmm {lib_ms:.4f}, bound "
        f"{nbytes(A_hi, A_lo, x, y) / HBM_BYTES_PER_S * 1e3:.4f}")


def check_comp(torch, bm, timer, rep, label, A_hi, A_lo, x64, timed=True):
    """Compensated kernel vs its plain version, and y_hi + y_lo vs the f64
    product of the same operands within 1e-12 of sum_j |a_ij x_j|."""
    x_hi, x_lo = bm.split_f64(x64)
    yh, yl = bm.block_mv_comp(A_hi, A_lo, x_hi, x_lo)
    rh, rl = bm.block_mv_comp_plain(A_hi, A_lo, x_hi, x_lo)
    torch.cuda.synchronize()
    A64 = A_hi.double() + A_lo.double()
    xs = x_hi.double() + x_lo.double()
    want = torch.einsum("bmk,bk->bm", A64, xs)
    scale = torch.einsum("bmk,bk->bm", A64.abs(), xs.abs())
    got = yh.double() + yl.double()
    ref = rh.double() + rl.double()
    worst = float(((got - want).abs() / scale.clamp_min(1e-300)).max())
    err = float((got - ref).abs().max())
    check(bool(torch.isfinite(got).all()), f"block_mv_comp {label}: "
          "non-finite")
    check(worst <= 1e-12, f"block_mv_comp {label}: {worst:.2e} > 1e-12 of "
          "the row scale")
    plain_rel = float(((ref - want).abs() / scale.clamp_min(1e-300)).max())
    check(plain_rel <= 1e-12, f"block_mv_comp_plain {label}: {plain_rel:.2e}")
    line = (f"  block_mv_comp {label} {tuple(A_hi.shape)}: max|d plain|="
            f"{err:.3e}, row-rel vs f64 {worst:.2e} (plain {plain_rel:.2e})")
    if timed:
        xb = xs[:, :, None]
        ms = timer(lambda: bm.block_mv_comp(A_hi, A_lo, x_hi, x_lo))
        plain_ms = timer(lambda: bm.block_mv_comp_plain(A_hi, A_lo, x_hi,
                                                        x_lo))
        lib_ms = timer(lambda: torch.bmm(A64, xb))  # f64 copy: a yardstick
        nb = nbytes(A_hi, A_lo, x_hi, x_lo, yh, yl)
        rep.add(ms, plain_ms, lib_ms, nb, 15 * A_hi.numel(), err)
        line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f}, f64 bmm "
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


def profile_minres(torch, solver, steps=100):
    """Device busy share of phase-1 MINRES: the card's kernel time under
    torch.profiler over the wall time of the same call run unprofiled."""
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
    from torch.autograd import DeviceType

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
        log(f"[profile] {steps} MINRES iterations: wall {wall_ms:.2f} ms; "
            "device time not measured (the profiler saw no device time)")
        return
    log(f"[profile] {steps} MINRES iterations: wall {wall_ms:.2f} ms "
        f"unprofiled, device kernel time {dev_ms:.2f} ms, device busy "
        f"{dev_ms / wall_ms:.3f} (idle {1 - dev_ms / wall_ms:.3f})")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<6d} {key[:70]}")


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
    from navier_stokes_tpu_torch.flagship import FlagshipSolve, build_model
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

    # 2. setup
    t0 = time.perf_counter()
    mesh = channel_with_cylinder_mesh_3d(MAXH)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = build_model(MAXH, order=ORDER, nu=NU, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = FlagshipSolve(m, tol=TOL)
    t_ops = time.perf_counter() - t0
    log(f"[setup] maxh={MAXH}: {mesh.ne} tets, {mesh.nv} vertices, "
        f"ndof={m.n}+{m.Q.ndof}")
    log(f"[setup] mesh {t_mesh:.1f} s, model build {t_model:.1f} s, "
        f"operators {t_ops:.1f} s "
        + ", ".join(f"({k} {v:.1f} s)" for k, v in
                    solver.setup_seconds.items()))
    check(m.n == 243312 and m.Q.ndof == 30960,
          f"unexpected size {m.n}+{m.Q.ndof}")

    # 3. kernel checks on the main path's tables
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    reports = {
        "block_mv": KernelReport(
            "block_mv", "navier_stokes_tpu/ops/pallas_mv.py:118"),
        "block_mv2": KernelReport(
            "block_mv2", "navier_stokes_tpu/ops/pallas_mv.py:124"),
        "block_mv_comp": KernelReport(
            "block_mv_comp", "navier_stokes_tpu/ops/pallas_mv.py:166"),
    }
    o32, ods = solver.ops32, solver.ops_ds
    log("[kernels] block_mv: every table of one preA apply")
    for label, A in o32["preA"].parts["tables"].items():
        check_block_mv(torch, bm, timer, reports["block_mv"], label, A, gen)
    log("[kernels] block_mv2: the split-f32 A32, B32, BT32 tables")
    for label, op in (("A32", o32["A"]), ("B32", o32["B"]),
                      ("BT32", o32["BT"])):
        check_block_mv2(torch, bm, timer, reports["block_mv2"], label,
                        *op.tables, gen)
    log("[kernels] block_mv_comp: the A_ds, B_ds, BT_ds tables and the "
        "cancellation case")
    for label, op in (("A_ds", ods["A"]), ("B_ds", ods["B"]),
                      ("BT_ds", ods["BT"])):
        hi, lo = op.tables
        x64 = torch.randn((hi.shape[0], hi.shape[2]), generator=gen,
                          device="cuda", dtype=torch.float64)
        check_comp(torch, bm, timer, reports["block_mv_comp"], label, hi, lo,
                   x64)
    for nblk, nb in ((37, 14), (m.fb.ne, m.fb.nb)):
        hi, lo, x64 = cancellation_case(torch, nblk, nb, 11)
        check_comp(torch, bm, timer, None, "cancellation 1e5", hi, lo, x64,
                   timed=False)

    # 4. main path
    bm.reset_launches()
    res = solver.full_solve()
    launches = dict(bm.LAUNCHES)
    for line in res.log:
        log(f"  cold {line}")
    log(f"[solve] cold: inner={res.inner}, {res.seconds:.3f} s, ds rel "
        f"{res.rel:.3e}, true f64 rel {res.true_rel:.3e}, launches "
        f"{launches}")
    u, p = res.x
    check(tuple(u.shape) == (m.n,) and tuple(p.shape) == (m.Q.ndof,),
          "solution has the wrong shape")
    check(bool(torch.isfinite(u).all() and torch.isfinite(p).all()),
          "solution is not finite")
    check(res.true_rel <= 1.01 * TOL,
          f"true f64 residual {res.true_rel:.3e} > {1.01 * TOL:.3e}")
    for name in reports:
        check(launches.get(name, 0) > 0, f"{name} never launched on the "
              "main path")
    bm.reset_launches()
    warm = solver.full_solve()
    for line in warm.log:
        log(f"  warm {line}")
    log(f"[solve] warm: inner={warm.inner}, {warm.seconds:.3f} s, "
        f"{warm.inner / warm.seconds:.1f} inner its/s, true f64 rel "
        f"{warm.true_rel:.3e}, launches {dict(bm.LAUNCHES)}")
    check(warm.true_rel <= 1.01 * TOL,
          f"warm true f64 residual {warm.true_rel:.3e}")
    # phase 2 on its own: at this configuration phase 1 already meets 1e-8,
    # so the compensated MINRES passes polish the warm solution to 1e-10
    bm.reset_launches()
    p2_log = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x0, x1, rel2, inner2 = solver.phase2(*warm.x, warm.rel, p2_log, t0,
                                         tol=1e-10)
    torch.cuda.synchronize()
    t_p2 = time.perf_counter() - t0
    true2 = solver.true_rel(*solver.residual64(x0, x1))
    for line in p2_log:
        log(f"  polish {line}")
    log(f"[solve] phase-2 polish to 1e-10: inner={inner2}, {t_p2:.3f} s, ds "
        f"rel {rel2:.3e}, true f64 rel {true2:.3e}, launches "
        f"{dict(bm.LAUNCHES)}")
    check(inner2 > 0 and bm.LAUNCHES["block_mv_comp"] > 0,
          "phase 2 did not run")
    check(true2 <= warm.true_rel, f"phase 2 raised the residual to {true2}")

    # 5. per-apply milliseconds (bench.py probe_ops)
    f32, f64 = torch.float32, torch.float64
    u32 = torch.ones(m.n, dtype=f32, device="cuda")
    p32 = torch.ones(m.Q.ndof, dtype=f32, device="cuda")
    u64 = torch.ones(m.n, dtype=f64, device="cuda")
    p64 = torch.ones(m.Q.ndof, dtype=f64, device="cuda")
    probes = [
        ("A32 split", o32["A"], u32),
        ("BT32*B32", lambda v: o32["BT"](o32["B"](v)), u32),
        ("preA32", o32["preA"], u32),
        ("preM32", o32["preM"], p32),
        ("A_ds", ods["A"], u64),
        ("BT_ds*B_ds", lambda v: ods["BT"](ods["B"](v)), u64),
        ("residual_pass", lambda v: solver.residual_pass(v, p64), u64),
        ("A64 (f64 torch)", m.A, u64),
    ]
    for key in ("pre_skel", "coarse_only", "smooth_only"):
        lay = o32["preA"].parts["layout"]
        probes.append((f"preA32.{key}", o32["preA"].parts[key],
                       torch.ones((lay.nface, lay.nfb), dtype=f32,
                                  device="cuda")))
    for name, fn, x in probes:
        log(f"[apply] {name:20s} {per_apply_ms(torch, fn, x):.4f} ms")

    # 6. where a phase-1 iteration's time goes
    profile_minres(torch, solver)

    kernels = {"kernels": [rep.entry(launches[name])
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

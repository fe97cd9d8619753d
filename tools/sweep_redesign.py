#!/usr/bin/env python3
"""Sweep of the launch constants of the redesigned hand-written kernels on
the card, with an earlier design beside them in the same call.

* Kernel 1 (``block_mv``, kernel 5's kernel at one sub-table), rows per
  CTA ``kMvRows`` of ``csrc/block_mv.cu`` in {32, 64, 128, 256}, on random
  tables of the shapes it streams on the GS solve's path at maxh=0.09: S,
  M_F and M_F^T (f32), ext, ext^T and inner (bf16), one color's GS row
  panels (f32).  Each variant must be BITWISE equal to the other tree's
  ``block_mv`` (without ``--parent``: the package's own), which is timed
  beside it with the f32 ``torch.bmm``.  Then one color's GS solve table
  (bf16, the segments of color 0 at maxh=0.09, ``GS_SEGMENTS``): each
  variant's ``block_mv_segments`` must EQUAL ``block_mv`` on the padded
  table, which, the other tree's ``block_mv`` on it and the f32
  ``torch.bmm`` of the padded table are timed beside it.
* Kernel 2 (``block_mv2``, kernel 6's kernel at one sub-table), the same
  constant, on random hi/lo pairs of the shapes of A32 (7740 x 54 x 54),
  B32 (7740 x 4 x 54) and BT32 (7740 x 54 x 4), each BITWISE equal to the
  other tree's ``block_mv2``, timed beside it with the f32 ``torch.bmm``
  of the stacked pair.
* Kernel 4 (``block_mv_comp``, kernel 7's kernel at one sub-table), rows
  per CTA ``kCompRows`` of ``csrc/block_mv.cu`` in {32, 64, 128}, on random
  hi/lo pairs of the shapes of the flagship's A_ds (7740 x 54 x 54), B_ds
  (7740 x 4 x 54) and BT_ds (7740 x 54 x 4) at maxh=0.09.  Each variant
  must be BITWISE equal to the plain version, as must the other tree's
  kernel 4, when one is given; the f64 ``torch.bmm`` of hi + lo (the
  yardstick of ``chip_smoke.py``) is timed beside it.
* Kernel 3 (``block_mv_ds``, the split-k kernel at one sub-table with
  three fmaf chains per row), its rows per CTA ``kCompRows`` in {32, 64,
  128} (the libraries of kernel 4's sweep), on random hi/lo pairs and
  x_hi/x_lo of the same three shapes.  Each of its three outputs must be
  BITWISE equal to the package's ``block_mv`` on its (table, vector) pair,
  A_hi x_hi, A_hi x_lo and A_lo x_hi, and, with ``--parent``, to the
  other tree's ``block_mv_ds``, which is timed beside it with the f32
  ``torch.bmm`` of the stacked pair with [x_hi, x_lo] (the yardstick of
  ``chip_smoke.py``).
* Kernel 7 (``block_mv_comp_splitk``), rows per sub-table
  ``kCompSplitRows`` in {16, 32, 64}, at k = 2 and 4, on the same shapes
  (tiles 256, 128, 128).  Each variant must be BITWISE equal to the
  package's own ``block_mv_comp``, which is timed beside it.
* Kernel 6 (``block_mv2_splitk``), rows per CTA summed over its
  sub-tables ``kSplitCtaRows`` in {32, 64, 128, 256}, at k = 2, 4 and 8
  (tile 256) on a random hi/lo pair of the shape of A32 (7740 x 54 x 54).
  Each variant, and the other tree's kernel 6, must be BITWISE equal to
  the package's own ``block_mv2``; it, the f32 ``torch.bmm`` of the
  stacked pair and ``block_mv_mega`` on the stacked pair (64 rows per CTA)
  are timed beside it.
* Kernel 5 (``block_mv_splitk``), the same constant, on the bench table of
  kernel 10 (7740 x 54 x 54 f32, k = 2, 4, 8 x tile 128, 256: the six
  variants of ``make_bmv_splitk_seq``) and at k = 2, 4, 8 (tile 256) on
  random tables of the shapes of the six tables it streams on the split-k
  solve's path at maxh=0.09: S, M_F and M_F^T (f32), ext, ext^T and inner
  (bf16).  Each variant must be BITWISE
  equal to the package's own ``block_mv``; it, the f32 ``torch.bmm`` and
  (f32 tables) ``block_mv_mega`` are timed beside it.
* Kernel 8 (``batched_local_matvec``), rows per CTA ``kRows`` of
  ``csrc/local_mv.cu`` in {32, 64, 128}, in float and double, on random
  tables of the shapes of the transient step's M_loc and A_cond (7740 x 54
  x 54) and S_inv (7740 x 4 x 4).  Each variant must stay within 2e-6
  (f32) or 1e-13 (f64) of sum_j |a_ij u_j| of the plain version;
  ``torch.bmm`` is timed beside it.
* Kernel 12 (``block_mv_ring``), the package's ``csrc/stream_mv.cu`` at the
  six variants of the ported microbenchmark (nbuf 2, 4, 8 x rows 64, 128)
  on a random 7740 x 54 x 54 f32 table.  Each must be BITWISE equal to
  ``block_mv`` and within 1e-4 of the plain version; ``torch.bmm`` and one
  ``block_mv_mega`` (64 rows per CTA, one bulk copy) are timed beside it.
* Kernel 9 (``block_mv_rows``), the package's ``csrc/stream_mv.cu`` at the
  four variants of the ported microbenchmark (rows 64, 192, 432, 864 per
  CTA) on a random 7740 x 54 x 54 f32 table.  Each must be BITWISE equal
  to ``block_mv`` and within 1e-4 of the plain version; ``torch.bmm`` and
  ``block_mv_mega`` at k = 1 (64 rows per CTA) are timed beside it.
* Kernel 13 (``block_mv_soa``), its tile constants ``kSoaE`` in {32, 64,
  128} elements, ``kSoaRi`` in {1, 2, 4} rows and ``kSoaStages`` in {2, 3,
  4} stages of ``csrc/stream_mv.cu``, where they fit, on the same random
  table packed as the microbenchmark packs it (54 x 54 x 7936, the element
  count zero-padded to 256).  Each must be BITWISE equal to ``block_mv``
  on the AoS table, come out zero in the padding columns and stay within
  1e-4 of the plain version; ``torch.bmm`` on the permuted views is timed
  beside it.

Each variant is the package's ``csrc/`` copied under ``build/sweep/`` with
that one constant rewritten (kernel 13: its three; kernels 9 and 12:
copied as it is; kernels 1 and 2 share ``kMvRows``, 3 and 4 ``kCompRows``
(one build each), 5 and 6 ``kSplitCtaRows``), compiled with the
package's nvcc flags (all nvcc processes at once), and called through the
package's own wrappers, whose library is swapped for the variant's.  With
``--parent DIR`` the ``csrc/`` of another tree (an earlier commit unpacked
with ``git archive``) is built and timed too.  Times are medians of 25
calls with the L2 flushed (``utils.timers.KernelTimer``), taken in the
order parent, variants, variants, parent; both passes are printed, and at
the end each variant's sum over the tables of the better pass.  An earlier
tree's library lacks the segment entry: its ``block_mv`` on the padded
table stands for it.  ``--only`` runs the named sections alone (and
builds only their libraries).  The last lines are the card's name and
power limit and a JSON object of every time; ``--out`` also writes it to a
file.

Run from the repository root, on the card::

    python3 tools/sweep_redesign.py [--parent build/parent] [--out FILE]
        [--only ds,comp1]
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from navier_stokes_tpu_torch.ops import block_mv as bm  # noqa: E402
from navier_stokes_tpu_torch.ops import local_mv as lm  # noqa: E402
from navier_stokes_tpu_torch.ops import stream_mv as sm  # noqa: E402
from navier_stokes_tpu_torch.scripts import microbench_dma  # noqa: E402
from navier_stokes_tpu_torch.utils.timers import KernelTimer  # noqa: E402

CSRC = ROOT / "navier_stokes_tpu_torch" / "csrc"
OUT = ROOT / "build" / "sweep"
NBLK, NB, NQ = 7740, 54, 4  # maxh=0.09: elements, velocity / pressure dofs
COMP_TABLES = (("A_ds", NB, NB, 256), ("B_ds", NQ, NB, 128),
               ("BT_ds", NB, NQ, 128))
LOCAL_TABLES = (("M_loc", NB), ("A_cond", NB), ("S_inv", NQ))
COMP1_ROWS = (32, 64, 128)  # kCompRows
COMP_ROWS = (16, 32, 64)  # kCompSplitRows
SPLITS = (2, 4)
SPLIT_ROWS = (32, 64, 128, 256)  # kSplitCtaRows
MV_SPLITS, MV_TILES, GS_TILE = (2, 4, 8), (128, 256), 256
NFACE = 16406  # faces at maxh=0.09: the blocks of M_F and M_F^T
# the six tables of kernel 5 on the split-k solve's path, at maxh=0.09
GS_TABLES = (("S", NBLK, NB - 6, NB - 6, torch.float32),
             ("ext", NBLK, 6, NB - 6, torch.bfloat16),
             ("ext^T", NBLK, NB - 6, 6, torch.bfloat16),
             ("inner", NBLK, 6, 6, torch.bfloat16),
             ("M_F", NFACE, 12, 9, torch.float32),
             ("M_F^T", NFACE, 9, 12, torch.float32))
# kernel 1 on the main path at maxh=0.09: the tables above, one color's
# GS row panels (its 7798 faces, 12 rows of 96 entries, f32) and one
# color's GS solve table (bf16): GS_SEGMENTS is color 0's (faces per
# block, blocks) -- 1496 blocks, padded to 8 faces = 96 entries
GS_PANELS = ("GS panels", 7799, 12, 96, torch.float32)
GS_SEGMENTS = ((2, 13), (3, 69), (4, 392), (5, 158), (6, 840), (7, 17),
               (8, 6))
NFB = 12  # face-block width: rows of one face in a GS block
MV1_ROWS = (32, 64, 128, 256)  # kMvRows
# kernel 2 on the phase-1 operators at maxh=0.09: A32, B32, BT32
MV2_TABLES = (("A32", NB, NB), ("B32", NQ, NB), ("BT32", NB, NQ))
LOCAL_ROWS = (32, 64, 128)  # kRows
# kernel 13's tile constants: elements, rows i and stages per CTA
SOA_E, SOA_RI, SOA_STAGES = (32, 64, 128), (1, 2, 4), (2, 3, 4)
SECTIONS = ("mv1", "comp1", "ds", "comp", "split", "local", "ring", "rows",
            "soa")
TOL = {torch.float32: 2e-6, torch.float64: 1e-13}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def variant(name: str, consts: dict | None = None, tag: str = "") -> Path:
    """``csrc/<name>.cu`` with ``constexpr int <const> = <value>;`` for each
    of ``consts`` (as it is without), in a copy of ``csrc/`` of its own
    (named after ``tag`` as well); returns the source's path."""
    consts = consts or {}
    dst = OUT / "_".join([name, *([tag] if tag else [])]
                         + [f"{c}_{v}" for c, v in consts.items()])
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst)
    src = dst / f"{name}.cu"
    text = src.read_text()
    for const, value in consts.items():
        text, n = re.subn(rf"(constexpr int {const} = )\d+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise RuntimeError(f"{const} is defined {n} times in {name}.cu")
    src.write_text(text)
    return src


def soa_fits(e: int, ri: int, stages: int, nb: int = NB) -> bool:
    """Whether kernel 13's CTA at these tile constants fits (csrc
    ``soa_smem`` and the thread limit)."""
    smem = 128 + 128 + 4 * e * nb * (stages * ri + 2)
    return smem <= sm.SMEM_OPT_IN and 32 + e * ri <= 1024


def compile_all(jobs: dict) -> dict:
    """{key: library path} for {key: source path}, all nvcc at once, one
    per distinct source."""
    def one(src):
        out = src.parent / f"lib{src.stem}.so"
        proc = subprocess.run([bm._nvcc(), *bm._NVCC_FLAGS, "-o", str(out),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        return out

    srcs = set(jobs.values())
    with ThreadPoolExecutor(len(srcs)) as pool:
        futs = {src: pool.submit(one, src) for src in srcs}
        return {key: futs[src].result() for key, src in jobs.items()}


def warm_up(seconds=1.0):
    """Products on the card for about ``seconds``, so that the first
    timings do not run at idle clocks."""
    a = torch.randn((4096, 4096), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()


def comp_pair(rng, m, kk):
    """A random f64 table (NBLK, m, kk) and x, split into f32 hi/lo pairs."""
    A64 = torch.as_tensor(rng.standard_normal((NBLK, m, kk)), device="cuda")
    x64 = torch.as_tensor(rng.standard_normal((NBLK, kk)), device="cuda")
    return A64, x64, bm.split_f64(A64), bm.split_f64(x64)


def sweep_comp1(timer, libs, rng, times):
    """Kernel 4: every variant (and the parent, first and last) on every
    table, each bitwise against the plain version, so all bitwise equal."""
    names = list(libs)
    order = names + names[::-1]
    for tname, m, kk, _ in COMP_TABLES:
        A64, x64, (hi, lo), (xh, xl) = comp_pair(rng, m, kk)
        want = bm.block_mv_comp_plain(hi, lo, xh, xl)
        xb = x64[:, :, None]
        tb = timer(lambda: torch.bmm(A64, xb))
        nbytes = 4 * (2 * hi.numel() + 4 * xh.numel())
        bound = nbytes / 3.35e12 * 1e3
        times["comp1"].append({"table": tname, "kernel": "f64 bmm",
                               "ms": [tb]})
        print(f"[comp1] {tname} {tuple(hi.shape)}: f64 bmm {tb:.4f} ms, "
              f"bound {bound:.4f}", flush=True)
        ms = {}
        for key in order:
            bm._lib = libs[key]
            got = bm.block_mv_comp(hi, lo, xh, xl)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"kernel 4 {key} {tname}: not bitwise "
                                   "equal to the plain version")
            ms.setdefault(key, []).append(timer(
                lambda: bm.block_mv_comp(hi, lo, xh, xl)))
        for key in names:
            times["comp1"].append({"table": tname, "kernel": key,
                                   "ms": ms[key]})
            print(f"  {key:10s} " + " / ".join(f"{t:.4f}" for t in ms[key])
                  + f" ms ({min(ms[key]) / tb:.3f} x f64 bmm, "
                  f"{bound / min(ms[key]):.3f} of bound), bitwise = plain",
                  flush=True)
    bm._lib = None


def sweep_ds(timer, libs, rng, times):
    """Kernel 3 (``kCompRows``) on random hi/lo pairs of the shapes of A_ds,
    B_ds and BT_ds, every variant BITWISE against the package's
    ``block_mv`` on each (table, vector) pair, and the parent's
    ``block_mv_ds`` (with ``--parent``) bitwise against the same."""
    main = bm.load_library()
    for tname, m, kk, _ in COMP_TABLES:
        _, _, (hi, lo), (xh, xl) = comp_pair(rng, m, kk)
        bm._lib = main
        ref = (bm.block_mv(hi, xh), bm.block_mv(hi, xl), bm.block_mv(lo, xh))
        Acat = torch.cat([hi, lo], dim=1)
        xcat = torch.stack([xh, xl], dim=2)
        tb = timer(lambda: torch.bmm(Acat, xcat))
        bound = 4 * (2 * hi.numel() + 2 * xh.numel() + 3 * NBLK * m) \
            / 3.35e12 * 1e3
        times["ds"].append({"table": tname, "kernel": "f32 bmm", "ms": [tb]})
        print(f"[ds] {tname} {tuple(hi.shape)} hi/lo: f32 bmm of the stacked "
              f"pair {tb:.4f} ms, bound {bound:.4f}", flush=True)
        timed_variants(timer, libs, lambda: bm.block_mv_ds(hi, lo, xh, xl),
                       ref, tname, times, "ds", {"table": tname}, bound, tb,
                       "block_mv on each pair")
        del Acat, xcat
    bm._lib = main


def sweep_comp(timer, libs, rng, times):
    """Kernel 7: every variant on every table at every k, bitwise against
    kernel 4 of the package's own build; the parent (if any) first and
    last."""
    names = list(libs)
    order = names + names[::-1]
    main = bm.load_library()
    for tname, m, kk, tile in COMP_TABLES:
        A64, x64, (hi, lo), (xh, xl) = comp_pair(rng, m, kk)
        bm._lib = main
        ref = bm.block_mv_comp(hi, lo, xh, xl)
        xb = x64[:, :, None]
        t4 = timer(lambda: bm.block_mv_comp(hi, lo, xh, xl))
        tb = timer(lambda: torch.bmm(A64, xb))
        times["comp"].append({"table": tname, "kernel": "block_mv_comp",
                              "ms": [t4]})
        times["comp"].append({"table": tname, "kernel": "f64 bmm",
                              "ms": [tb]})
        nbytes = 4 * (2 * hi.numel() + 4 * xh.numel())
        bound = nbytes / 3.35e12 * 1e3
        print(f"[comp] {tname} {tuple(hi.shape)}: block_mv_comp {t4:.4f} ms, "
              f"f64 bmm {tb:.4f}, bound {bound:.4f}", flush=True)
        for k in SPLITS:
            his, los = bm.pack_splitk(hi, k, tile), bm.pack_splitk(lo, k, tile)
            ms = {}
            for key in order:
                bm._lib = libs[key]
                got = bm.block_mv_comp_splitk(his, los, xh, xl, tile)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise RuntimeError(f"kernel 7 {key} {tname} k={k}: not "
                                       "bitwise equal to block_mv_comp")
                ms.setdefault(key, []).append(timer(
                    lambda: bm.block_mv_comp_splitk(his, los, xh, xl, tile)))
            for key in names:
                times["comp"].append({"table": tname, "k": k, "kernel": key,
                                      "ms": ms[key]})
                print(f"  k={k} {key:10s} "
                      + " / ".join(f"{t:.4f}" for t in ms[key])
                      + f" ms ({min(ms[key]) / tb:.3f} x f64 bmm, "
                      f"{bound / min(ms[key]):.3f} of bound), bitwise = "
                      "block_mv_comp", flush=True)
            del his, los
    bm._lib = main


def same(got, ref) -> bool:
    """Bitwise equality of two outputs, tensors or tuples of tensors."""
    if isinstance(ref, tuple):
        return all(torch.equal(a, b) for a, b in zip(got, ref, strict=True))
    return torch.equal(got, ref)


def timed_variants(timer, libs, call, ref, label, times, section, row,
                   bound, base, what="unsplit"):
    """Every ``block_mv.cu`` library of ``libs`` (the parent first and
    last, if any) on one call, each BITWISE equal to ``ref`` (the output of
    ``what``: a tensor or a tuple of them); appends one row per library to
    ``times[section]`` and prints its line (``base``: the yardstick's
    ms)."""
    names = list(libs)
    ms = {}
    for key in names + names[::-1]:
        bm._lib = libs[key]
        got = call()
        torch.cuda.synchronize()
        if not same(got, ref):
            raise RuntimeError(f"{label} {key}: not bitwise equal to {what}")
        ms.setdefault(key, []).append(timer(call))
    for key in names:
        times[section].append({**row, "kernel": key, "ms": ms[key]})
        print(f"  {label} {key:10s} " + " / ".join(f"{t:.4f}" for t in ms[key])
              + f" ms ({min(ms[key]) / base:.3f} x f32 bmm, "
              f"{bound / min(ms[key]):.3f} of bound), bitwise = {what}",
              flush=True)


def reference(libs, main, call):
    """``call``'s output through the parent's library if ``libs`` has one,
    else through the package's own build ``main``: what every variant must
    equal."""
    bm._lib = libs.get("parent", main)
    out = call()
    torch.cuda.synchronize()
    return out


def sweep_mv1(timer, libs, rng, times):
    """Kernel 1 (``kMvRows``) on random tables of the main path's shapes,
    every variant BITWISE against the parent's ``block_mv`` (the package's
    own build without ``--parent``); then one color's GS solve table by
    segment, every variant EQUAL to ``block_mv`` on the padded table,
    beside the parent's and the package's ``block_mv`` on it."""
    main = bm.load_library()
    shapes = [(name, nblk, m, kk, dt) for name, nblk, m, kk, dt in GS_TABLES]
    for name, nblk, m, kk, dt in shapes + [GS_PANELS]:
        A = torch.as_tensor(rng.standard_normal((nblk, m, kk)).astype(
            np.float32), device="cuda").to(dt)
        x = torch.as_tensor(rng.standard_normal((nblk, kk)).astype(
            np.float32), device="cuda")
        Af, xb = A.to(torch.float32), x[:, :, None]
        bm._lib = main
        tb = timer(lambda: torch.bmm(Af, xb))
        bound = (A.numel() * A.element_size() + 4 * x.numel()
                 + 4 * nblk * m) / 3.35e12 * 1e3
        times["mv1"].append({"table": name, "kernel": "f32 bmm", "ms": [tb]})
        print(f"[mv1] {name} {tuple(A.shape)} {str(dt)[6:]}: f32 bmm "
              f"{tb:.4f} ms, bound {bound:.4f}", flush=True)
        ref = reference(libs, main, lambda: bm.block_mv(A, x))
        timed_variants(timer, libs, lambda: bm.block_mv(A, x), ref, name,
                       times, "mv1", {"table": name}, bound, tb,
                       "the parent's block_mv" if "parent" in libs
                       else "block_mv")
    # one color's GS solve table, padded and by segment
    blocks = [torch.as_tensor(rng.standard_normal((n, f * NFB, f * NFB)),
                              device="cuda") for f, n in GS_SEGMENTS]
    nblk = sum(n for _, n in GS_SEGMENTS) + 1
    width = max(f for f, _ in GS_SEGMENTS) * NFB
    T = bm.pack_segments(blocks, nblk, width, torch.bfloat16, "cuda")
    del blocks
    P = T.padded()
    x = torch.as_tensor(rng.standard_normal((nblk, width)).astype(
        np.float32), device="cuda")
    Pf, xb = P.to(torch.float32), x[:, :, None]
    bm._lib = main
    tb = timer(lambda: torch.bmm(Pf, xb))
    tp = timer(lambda: bm.block_mv(P, x))
    want = bm.block_mv(P, x)
    bound = (T.real_bytes + 8 * x.numel()) / 3.35e12 * 1e3
    rows = [{"kernel": "f32 bmm padded", "ms": [tb]},
            {"kernel": "block_mv padded", "ms": [tp]}]
    line = f"f32 bmm padded {tb:.4f} ms, block_mv padded {tp:.4f}"
    if "parent" in libs:
        bm._lib = libs["parent"]
        got = bm.block_mv(P, x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError("the parent's block_mv on the padded GS "
                               "solve table differs from this tree's")
        tq = timer(lambda: bm.block_mv(P, x))
        rows.append({"kernel": "parent block_mv padded", "ms": [tq]})
        line += f", the parent's block_mv padded {tq:.4f}"
    times["mv1_seg"] += rows
    print(f"[mv1_seg] GS solve {tuple(P.shape)} bf16, {T.real_bytes / 1e6:.2f}"
          f" MB by segment ({P.numel() * 2 / 1e6:.2f} MB padded): {line}, "
          f"bound on the segments {bound:.4f}", flush=True)
    seg_libs = {key: lib for key, lib in libs.items() if key != "parent"}
    timed_variants(timer, seg_libs, lambda: bm.block_mv_segments(T, x), want,
                   "segments", times, "mv1_seg", {}, bound, tb,
                   "block_mv padded (as values)")
    bm._lib = main


def sweep_mv2_unsplit(timer, libs, rng, times):
    """Kernel 2 (``kMvRows``) on random hi/lo pairs of the shapes of A32,
    B32 and BT32, every variant BITWISE against the parent's ``block_mv2``
    (the package's own build without ``--parent``)."""
    main = bm.load_library()
    for name, m, kk in MV2_TABLES:
        A64 = torch.as_tensor(rng.standard_normal((NBLK, m, kk)),
                              device="cuda")
        hi, lo = bm.split_f64(A64)
        del A64
        x = torch.as_tensor(rng.standard_normal((NBLK, kk)).astype(
            np.float32), device="cuda")
        Acat = torch.cat([hi, lo], dim=2)
        xb = torch.cat([x, x], dim=1)[:, :, None]
        tb = timer(lambda: torch.bmm(Acat, xb))
        bound = 4 * (2 * hi.numel() + x.numel() + NBLK * m) / 3.35e12 * 1e3
        times["mv2_1"].append({"table": name, "kernel": "f32 bmm",
                               "ms": [tb]})
        print(f"[mv2_1] {name} {tuple(hi.shape)} hi/lo: f32 bmm {tb:.4f} ms, "
              f"bound {bound:.4f}", flush=True)
        ref = reference(libs, main, lambda: bm.block_mv2(hi, lo, x))
        timed_variants(timer, libs, lambda: bm.block_mv2(hi, lo, x), ref,
                       name, times, "mv2_1", {"table": name}, bound, tb,
                       "the parent's block_mv2" if "parent" in libs
                       else "block_mv2")
    bm._lib = main


def sweep_mv2(timer, libs, rng, times):
    """Kernel 6 on the A32-shaped pair at k = 2, 4, 8, every variant
    bitwise against the package's own ``block_mv2``."""
    main = bm.load_library()
    A64 = torch.as_tensor(rng.standard_normal((NBLK, NB, NB)), device="cuda")
    hi, lo = bm.split_f64(A64)
    del A64
    x = torch.as_tensor(rng.standard_normal((NBLK, NB)).astype(np.float32),
                        device="cuda")
    ref = bm.block_mv2(hi, lo, x)
    Acat = torch.cat([hi, lo], dim=2)
    xcat = torch.cat([x, x], dim=1).contiguous()
    xb = xcat[:, :, None]
    tb = timer(lambda: torch.bmm(Acat, xb))
    t2 = timer(lambda: bm.block_mv2(hi, lo, x))
    tm = timer(lambda: sm.block_mv_mega(Acat, xcat, 2, 32))
    bound = 4 * (2 * hi.numel() + 2 * x.numel()) / 3.35e12 * 1e3
    times["mv2"] += [{"kernel": "f32 bmm", "ms": [tb]},
                     {"kernel": "block_mv2", "ms": [t2]},
                     {"kernel": "block_mv_mega k=2 rows=32", "ms": [tm]}]
    print(f"[mv2] A32 {tuple(hi.shape)} hi/lo: f32 bmm {tb:.4f} ms, "
          f"block_mv2 {t2:.4f}, block_mv_mega on the stacked pair {tm:.4f}, "
          f"bound {bound:.4f}", flush=True)
    for k in MV_SPLITS:
        hs, ls = bm.pack_splitk(hi, k, 256), bm.pack_splitk(lo, k, 256)
        timed_variants(timer, libs,
                       lambda: bm.block_mv2_splitk(hs, ls, x, 256), ref,
                       f"k={k}", times, "mv2", {"k": k}, bound, tb)
        del hs, ls
    bm._lib = main


def sweep_mv(timer, libs, rng, times):
    """Kernel 5 on the bench table (the six variants of kernel 10) and on
    the GS-shaped tables at k = 2, 4, 8, every variant bitwise against the
    package's own ``block_mv``."""
    main = bm.load_library()

    def table(nblk, m, kk, dt):
        A = torch.as_tensor(rng.standard_normal((nblk, m, kk)).astype(
            np.float32), device="cuda").to(dt)
        x = torch.as_tensor(rng.standard_normal((nblk, kk)).astype(
            np.float32), device="cuda")
        return A, x

    def yardsticks(name, A, x, section, row):
        Af, xb = A.to(torch.float32), x[:, :, None]
        tb = timer(lambda: torch.bmm(Af, xb))
        t1 = timer(lambda: bm.block_mv(A, x))
        line = f"f32 bmm {tb:.4f} ms, block_mv {t1:.4f}"
        times[section] += [{**row, "kernel": "f32 bmm", "ms": [tb]},
                           {**row, "kernel": "block_mv", "ms": [t1]}]
        if A.dtype == torch.float32:
            tm = timer(lambda: sm.block_mv_mega(A, x, 2, 32))
            line += f", block_mv_mega k=2 rows=32 {tm:.4f}"
            times[section].append({**row, "kernel": "block_mv_mega",
                                   "ms": [tm]})
        bound = (A.numel() * A.element_size() + 4 * x.numel()
                 + 4 * A.shape[0] * A.shape[1]) / 3.35e12 * 1e3
        print(f"[{section}] {name} {tuple(A.shape)} {str(A.dtype)[6:]}: "
              f"{line}, bound {bound:.4f}", flush=True)
        return tb, bound

    bm._lib = main
    A, x = table(NBLK, NB, NB, torch.float32)
    ref = bm.block_mv(A, x)
    tb, bound = yardsticks("bench", A, x, "mv_bench", {})
    for k in MV_SPLITS:
        for tile in MV_TILES:
            subs = bm.pack_splitk(A, k, tile)
            timed_variants(timer, libs,
                           lambda: bm.block_mv_splitk(subs, x, tile), ref,
                           f"k={k} tile={tile}", times, "mv_bench",
                           {"table": f"k={k} tile={tile}"}, bound, tb)
            del subs
    for name, nblk, m, kk, dt in GS_TABLES:
        bm._lib = main
        A, x = table(nblk, m, kk, dt)
        ref = bm.block_mv(A, x)
        tb, bound = yardsticks(name, A, x, "mv_gs", {"table": name})
        for k in MV_SPLITS:
            subs = bm.pack_splitk(A, k, GS_TILE)
            timed_variants(timer, libs,
                           lambda: bm.block_mv_splitk(subs, x, GS_TILE), ref,
                           f"{name} k={k}", times, "mv_gs",
                           {"table": name, "k": k}, bound, tb)
            del subs


def sweep_local(timer, libs, rng, times):
    """Kernel 8: every variant on every table in both types."""
    names = list(libs)
    order = names + names[::-1]
    for dt in (torch.float32, torch.float64):
        for tname, nb in LOCAL_TABLES:
            A = torch.as_tensor(rng.standard_normal((NBLK, nb, nb)),
                                device="cuda").to(dt)
            u = torch.as_tensor(rng.standard_normal((NBLK, nb)),
                                device="cuda").to(dt)
            want = lm.batched_local_matvec_plain(A, u)
            scale = torch.einsum("eij,ej->ei", A.double().abs(),
                                 u.double().abs()).clamp_min(1e-300)
            ub = u[:, :, None]
            tb = timer(lambda: torch.bmm(A, ub))
            nbytes = A.element_size() * (A.numel() + 2 * u.numel())
            bound = nbytes / 3.35e12 * 1e3
            times["local"].append({"dtype": str(dt)[6:], "table": tname,
                                   "kernel": "bmm", "ms": [tb]})
            print(f"[local] {str(dt)[6:]} {tname} {tuple(A.shape)}: bmm "
                  f"{tb:.4f} ms, bound {bound:.4f}", flush=True)
            ms = {}
            for key in order:
                lm._lib = libs[key]
                y = lm.batched_local_matvec(A, u)
                torch.cuda.synchronize()
                worst = float(((y - want).abs().double() / scale).max())
                if not worst <= TOL[dt]:
                    raise RuntimeError(f"kernel 8 {key} {tname} {dt}: "
                                       f"{worst:.2e} > {TOL[dt]:.0e}")
                ms.setdefault(key, []).append(timer(
                    lambda: lm.batched_local_matvec(A, u)))
            for key in names:
                times["local"].append({"dtype": str(dt)[6:], "table": tname,
                                       "kernel": key, "ms": ms[key]})
                print(f"  {key:10s} "
                      + " / ".join(f"{t:.4f}" for t in ms[key])
                      + f" ms ({min(ms[key]) / tb:.3f} x bmm, "
                      f"{bound / min(ms[key]):.3f} of bound)", flush=True)
    lm._lib = None


def stream_variants(timer, libs, own, call, check, label, times, section,
                    row, bound, base):
    """Every ``stream_mv.cu`` library of ``libs`` (the parent first and
    last, if any) on one call, each passing ``check(out)`` (which raises);
    appends one row per library to ``times[section]`` and prints its line
    (``base``: the ``torch.bmm`` ms).  ``own``: the package's own build, left
    in place."""
    names = list(libs)
    ms = {}
    for key in names + names[::-1]:
        sm._lib = libs[key]
        out = call()
        torch.cuda.synchronize()
        check(key, out)
        ms.setdefault(key, []).append(timer(call))
    sm._lib = own
    for key in names:
        times[section].append({**row, "kernel": key, "ms": ms[key]})
        print(f"  {label} {key:22s} "
              + " / ".join(f"{t:.4f}" for t in ms[key])
              + f" ms ({min(ms[key]) / base:.3f} x bmm, "
              f"{bound / min(ms[key]):.3f} of bound)", flush=True)


def bench_table(rng):
    """The microbenchmarks' random f32 table (7740 x 54 x 54) and x."""
    A = torch.as_tensor(rng.standard_normal((NBLK, NB, NB)).astype(
        np.float32), device="cuda")
    x = torch.as_tensor(rng.standard_normal((NBLK, NB)).astype(np.float32),
                        device="cuda")
    return A, x


def sweep_ring(timer, libs, rng, times):
    """Kernel 12: the six variants of the ported microbenchmark, this
    tree's kernel and the parent's, bitwise against ``block_mv``."""
    own = sm.load_library()
    A, x = bench_table(rng)
    ref, want = bm.block_mv(A, x), bm.block_mv_plain(A, x)
    xb = x[:, :, None]
    tb = timer(lambda: torch.bmm(A, xb))
    tm = timer(lambda: sm.block_mv_mega(A, x, 2, 32))
    bound = 4 * (A.numel() + 2 * x.numel()) / 3.35e12 * 1e3
    times["ring"] += [{"kernel": "bmm", "ms": [tb]},
                      {"kernel": "block_mv_mega k=2 rows=32", "ms": [tm]}]
    print(f"[ring] {tuple(A.shape)} f32: bmm {tb:.4f} ms, block_mv_mega k=2 "
          f"rows=32 {tm:.4f}, bound {bound:.4f}", flush=True)
    for nbuf in microbench_dma.RING_NBUF:
        for rows in microbench_dma.RING_ROWS:
            def check(key, y):
                err = float((y - want).abs().max())
                if not (torch.equal(y, ref) and err <= 1e-4):
                    raise RuntimeError(f"kernel 12 {key} nbuf={nbuf} rows="
                                       f"{rows}: not bitwise equal to "
                                       f"block_mv, or {err:.2e} > 1e-4")

            stream_variants(timer, libs, own,
                            lambda: sm.block_mv_ring(A, x, nbuf, rows), check,
                            f"nbuf={nbuf} rows={rows:3d}", times, "ring",
                            {"table": f"nbuf={nbuf} rows={rows}"}, bound, tb)


def sweep_rows(timer, libs, rng, times):
    """Kernel 9: the four rows variants of the ported microbenchmark, this
    tree's kernel and the parent's, bitwise against ``block_mv``."""
    own = sm.load_library()
    A, x = bench_table(rng)
    ref, want = bm.block_mv(A, x), bm.block_mv_plain(A, x)
    xb = x[:, :, None]
    tb = timer(lambda: torch.bmm(A, xb))
    tm = timer(lambda: sm.block_mv_mega(A, x, 1, 64))
    bound = 4 * (A.numel() + 2 * x.numel()) / 3.35e12 * 1e3
    times["rows"] += [{"kernel": "bmm", "ms": [tb]},
                      {"kernel": "block_mv_mega k=1 rows=64", "ms": [tm]}]
    print(f"[rows] {tuple(A.shape)} f32: bmm {tb:.4f} ms, block_mv_mega k=1 "
          f"rows=64 {tm:.4f}, bound {bound:.4f}", flush=True)
    for rows in microbench_dma.ROWS:
        def check(key, y):
            err = float((y - want).abs().max())
            if not (torch.equal(y, ref) and err <= 1e-4):
                raise RuntimeError(f"kernel 9 {key} rows={rows}: not bitwise "
                                   f"equal to block_mv, or {err:.2e} > 1e-4")

        stream_variants(timer, libs, own,
                        lambda: sm.block_mv_rows(A, x, rows), check,
                        f"rows={rows:3d}", times, "rows",
                        {"table": f"rows={rows}"}, bound, tb)


def sweep_soa(timer, libs, rng, times):
    """Kernel 13: every fitting tile variant and the parent's kernel on the
    bench table in structure-of-arrays layout, bitwise against ``block_mv``
    on the AoS table."""
    own = sm.load_library()
    A, x = bench_table(rng)
    ref = bm.block_mv(A, x)
    ne_p = -(-NBLK // 256) * 256
    A2 = torch.zeros((NB, NB, ne_p), device="cuda")
    A2[:, :, :NBLK] = A.permute(1, 2, 0)
    uT = torch.zeros((NB, ne_p), device="cuda")
    uT[:, :NBLK] = x.T
    del A
    want = sm.block_mv_soa_plain(A2, uT)
    A2b, uTb = A2.permute(2, 0, 1), uT.T[:, :, None]  # views: same inputs
    tb = timer(lambda: torch.bmm(A2b, uTb))
    bound = 4 * (A2.numel() + 2 * uT.numel()) / 3.35e12 * 1e3
    times["soa"].append({"kernel": "bmm", "ms": [tb]})
    print(f"[soa] {tuple(A2.shape)} f32: bmm on the permuted views {tb:.4f} "
          f"ms, bound {bound:.4f}", flush=True)

    def check(key, y):
        err = float((y - want).abs().max())
        if not (torch.equal(y[:, :NBLK].T, ref) and err <= 1e-4
                and float(y[:, NBLK:].abs().max()) == 0.0):
            raise RuntimeError(f"kernel 13 {key}: not bitwise equal to "
                               f"block_mv, padding not zero, or {err:.2e} > "
                               "1e-4")

    stream_variants(timer, libs, own, lambda: sm.block_mv_soa(A2, uT), check,
                    "soa", times, "soa", {}, bound, tb)


def summary(times):
    """Each kernel's sum over its tables of the better pass, per section
    (and per k for kernels 5-7, per type for kernel 8; the six variants of
    ``mv_bench`` summed together)."""
    for section, rows in times.items():
        sums = {}
        for r in rows:
            key = (r.get("k"), r.get("dtype"), r["kernel"])
            sums[key] = sums.get(key, 0.0) + min(r["ms"])
        for (k, dt, kernel), total in sums.items():
            what = " ".join(str(v) for v in (f"k={k}" if k else None, dt)
                            if v)
            print(f"[sum] {section} {what} {kernel}: {total:.4f} ms",
                  flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another tree whose csrc/ is timed "
                    "beside the variants")
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--only", help="comma-separated sections to run (of "
                    + ", ".join(SECTIONS) + "; default all)")
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else list(SECTIONS)
    if not set(only) <= set(SECTIONS):
        ap.error(f"--only: sections are {', '.join(SECTIONS)}")
    if not torch.cuda.is_available():
        print("sweep_redesign: no CUDA device available", file=sys.stderr)
        return 2
    consts = {"comp1": ("block_mv", "kCompRows", COMP1_ROWS),
              "ds": ("block_mv", "kCompRows", COMP1_ROWS),
              "comp": ("block_mv", "kCompSplitRows", COMP_ROWS),
              "split": ("block_mv", "kSplitCtaRows", SPLIT_ROWS),
              "mv1": ("block_mv", "kMvRows", MV1_ROWS),
              "local": ("local_mv", "kRows", LOCAL_ROWS)}
    jobs = {(kind, f"R={r}"): variant(name, {const: r})
            for kind, (name, const, values) in consts.items() if kind in only
            for r in values}
    for kind in ("ring", "rows"):
        if kind in only:
            jobs[(kind, "this tree")] = variant("stream_mv", tag=kind)
    if "soa" in only:
        jobs.update({("soa", f"E={e} ri={ri} nbuf={st}"): variant(
            "stream_mv", {"kSoaE": e, "kSoaRi": ri, "kSoaStages": st})
            for e in SOA_E for ri in SOA_RI for st in SOA_STAGES
            if soa_fits(e, ri, st)})
    sources = {"comp1": "block_mv", "ds": "block_mv", "comp": "block_mv",
               "split": "block_mv", "mv1": "block_mv", "local": "local_mv",
               "ring": "stream_mv", "rows": "stream_mv", "soa": "stream_mv"}
    sources = {kind: name for kind, name in sources.items() if kind in only}
    if args.parent:
        csrc = Path(args.parent).resolve() / "navier_stokes_tpu_torch" / "csrc"
        for name in set(sources.values()):
            dst = OUT / f"parent_{name}"
            shutil.rmtree(dst, ignore_errors=True)
            shutil.copytree(csrc, dst)
            jobs[(name, "parent")] = dst / f"{name}.cu"
    with ThreadPoolExecutor(1) as pool:  # the package's own libraries
        own = pool.submit(bm.build_all)
        paths = compile_all(jobs)
        own.result()
    print(f"[build] {len(set(jobs.values()))} libraries and the package's "
          "own", flush=True)
    binders = {"block_mv": bm._bind, "local_mv": lm._bind,
               "stream_mv": sm._bind}
    libs = {kind: {} for kind in sources}
    if args.parent:
        for kind, name in sources.items():
            libs[kind]["parent"] = binders[name](paths[(name, "parent")])
    for (kind, key), path in paths.items():
        if key != "parent":
            libs[kind][key] = binders[sources[kind]](path)
    timer = KernelTimer()
    warm_up()
    rng = np.random.default_rng(0)
    times = {kind: [] for kind in ("mv1", "mv1_seg", "mv2_1", "comp1", "ds",
                                   "comp", "mv2", "mv_bench", "mv_gs",
                                   "local", "ring", "rows", "soa")}
    runs = {"mv1": (sweep_mv1, sweep_mv2_unsplit), "comp1": (sweep_comp1,),
            "ds": (sweep_ds,),
            "comp": (sweep_comp,), "split": (sweep_mv2, sweep_mv),
            "local": (sweep_local,), "ring": (sweep_ring,),
            "rows": (sweep_rows,), "soa": (sweep_soa,)}
    for kind in SECTIONS:
        if kind in only:
            for fn in runs[kind]:
                fn(timer, libs[kind], rng, times)
    summary(times)
    card = card_line()
    times["card"] = card
    print(card, flush=True)
    line = json.dumps(times)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   tests, which import no JAX -- must pass all 44 cases, none skipped.
   They run in a process of their own while step 3 builds the models on
   the host, and are waited for before the first timed kernel check, so
   the setup seconds of step 3 are taken beside them (its lines say so);
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
    block inverses against its plain version, and a solve with the JAX
    package's Bramble-Pasciak k, held to its count (the solve with their
    own k was cut to make room for later phases); the model's state is
    put back;
12. transient: the float32 twin of the curved model (same host tables),
    ``make_step_fn(project_tol=1e-5)`` from ``u = u_bc`` as bench.py's
    ``measure_transient``: one cold step with the launch counters set to 0
    just before it, then n warm steps (n calibrated to about 10 s, 3..200):
    steps/s, the M* and projection CG counts of every step, the
    projection's reduction of ||B u||, whether a step is bitwise
    repeatable, per-piece milliseconds (the harness of
    ``scripts/probe_transient``: each apply by graph replay and eagerly,
    the CG solves and the step by the host clock, the standalone CG counts
    equal to the step's) and the device busy share; then 3
    float64 steps (project_tol=1e-9) from the flagship solution, the
    counters read after the first; then repeat: two f32 steps from the
    same state must give bitwise equal increments and equal CG counts
    (every scatter of the port is a deterministic ``ScatterPlan``); then
    sweep: the Reynolds-number ensemble of ``parallel/sweep.py`` (the JAX
    package's BASELINE config 5) on the curved f64 model from the
    flagship solution, 2 viscosities (members 0 and 4 of geomspace(1e-3,
    1e-2, 8); all 8 through PR 16) x 2 steps
    through ``run_reynolds_ensemble_mcs`` with the counters set to 0 just
    before it (kernel 8 in f64 must launch; it is also checked on the
    step's nu-split tables G1, G2, G3 and the mass): every state finite,
    the first and last members apart, each of them run alone bitwise equal
    to its row, the member at the model's nu within 1e-6 of max |u| of
    ``DoTimeStep``, the C++ meshkit kernels loaded; the M* and projection
    CG counts and seconds of every member step; then the same ensemble on
    the straight channel at maxh 0.35 from u_bc with the JAX model's
    Chebyshev bounds and the JAX host's element-interior BDM_2 functions
    (tools/jax_bdm2_cell_bases.npz), held to the JAX package's per-member
    max |u|, ||u_i - u_0||, ||u_i - u_bc|| and CG counts at the step's own
    M* CG stop (SWEEP_SMALL_TOL) and with the M* CG to 1e-10
    (SWEEP_TIGHT_TOL), where the step with its nu-split and mass applies
    in float32 must break the bound (tools/jax_sweep_reference.py);
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
    true f64 residual (<= 1.01e-8) and seconds of each; then probes: the
    three attribution scripts of ``navier_stokes_tpu_torch/scripts`` on
    the main path's solver and f32 twin -- ``microbench_sweep`` (every
    piece of the GS preA by the slope between CUDA graphs of 10 and 60
    chained applies and eagerly, every color step and the share of it its
    row gathers take), ``probe_transient`` (from u_bc) and
    ``audit_tables`` (the JAX script's cost model, the port's tables, and
    the launches of one preA apply equal to its stream counts); then
    skeleton-slow: the dof-level skeleton preconditioner
    (``fast=False``), additive and GS, all tables f64, on the straight
    channel at maxh 0.35, built on the card and on the CPU (plain
    versions) and held together within 1e-12, against the fast path
    (additive 1e-7; GS a gap under 0.5, both symmetric to 1e-8), kernel 8
    in f64 launched in one apply of each and checked on its square tables,
    and the per-apply ms of the slow and the fast preA;
14. microbench: the ported microbenchmark scripts
    (``navier_stokes_tpu_torch.scripts.microbench_dma`` on the
    7740 x 54 x 54 f32 table, ``microbench_apply2`` at maxh=0.09) with the
    launch counters set to 0 just before; each of the five table-stream
    wrappers must have launched, and the split-k variants must be bitwise
    equal to ``block_mv``; then ``microbench_apply`` (y = A u by gather +
    kernel 8 + scatter, by the face-block apply through kernel 8 and
    kernel 1, and the einsum alone, with TF32 on and off) and
    ``microbench_apply3`` (kernel 1 and kernel 2 against the einsums,
    alone and in the face apply) at maxh=0.09, the counters set to 0
    again: kernels 1, 2 and 8 (f32) must launch, every deviation within
    its script's bound;
15. amg: at maxh=0.04 (5,859 free velocity-P1 vertices, above the dense
    limit of 5,000, so both coarse solves are SA-AMG V-cycles):
    AMG-preconditioned CG on the P1 stiffness to 1e-8 in under 40
    iterations with the V-cycle symmetric to 1e-10, the curved GS flagship
    solve cold and warm to a true f64 residual <= 1.01e-8, and one cold and
    three warm float32 transient steps.  The two-rank face-sharded solve of
    step 20 runs in a process of its own beside this step's host setup
    (lines marked "beside [shard-face]") and is waited for before its
    first solve;
16. hdg3d: ``NavierStokesHDG3D`` at the demo's configuration
    (scripts/navier_stokes_3d.py --hdg, the reference's
    NavierStokesSIMPLE_test_3D.py: the straight channel at maxh=0.09,
    order 2, nu=1e-3, dt=2e-3, the auxspace preconditioner with 1,794
    vertex-star blocks of up to 1,056 dofs, their inverses taken on the
    card in f64), after the MCS models are let go: setup seconds by part;
    kernel 8 on its f64 element and vertex-star tables against the plain
    version; ``SolveInitial(tol=1e-8)`` (BPCG iterations, seconds, launches
    per iteration, true f64 residual <= 1.01e-8); ``Project`` (||B u|| <
    1e-7); two steps from the same state bitwise equal; 1 ``DoTimeStep``
    (3 through PR 16)
    (finite, steps/s, CG counts, launches per step); an f32 twin whose
    kernel-8 and kernel-1 tables are checked the same way, and
    ``solve_initial_refined`` on the pair (its guard: a finite result
    below the starting residual, reported);
17. mcs2d, th2d: the 2D models at the 2D demo's configuration
    (scripts/navier_stokes_2d.py, the reference's NavierStokesSIMPLE_test.py:
    ``channel_with_cylinder_mesh(0.05)``, 762 triangles, order 2, nu=1e-3,
    dt=1e-3).  ``NavierStokesMCS`` with the auxspace GS preconditioner:
    setup seconds; kernel 8 (f64) on its A_cond, mass, projection-block and
    every color's vertex-star inverse table against the plain version;
    ``SolveInitial(iterative=True, GS=True, tol=1e-10)`` with the JAX
    package's Bramble-Pasciak k (its count held to the JAX CPU count of
    ``tools/jax_bpcg_reference_2d.py`` by ``count_matches``) and with its
    own, the true f64 residual; two f64 steps from one state bitwise equal
    (``[repeat]``); 5 ``DoTimeStep``s (20 through PR 16; steps/s, CG
    counts); then the same
    at maxh=0.01 (17,002 triangles, 179,951 + 51,006 dofs; JAX 662).
    The Taylor-Hood ``NavierStokes`` at maxh=0.05: kernel 8 on its viscous,
    mass and patch-inverse tables, ``SolveInitial`` with the JAX k (count
    held the same way), 5 steps.  Kernel 8 must launch in each solve and
    each run of steps; the counters are set to 0 just before each solve
    and before each run of steps;
18. stokes, heat: the Stokes catalog and the heat model.  ``[stokes]``:
    the active configuration of scripts/run_stokes.py ("HDG BDM 2", alpha
    10, edgeblock, order-3 curved cylinder, Bramble-Pasciak CG to 1e-7)
    through the port's ``run`` harness as the script calls it at maxh 0.1
    (410 triangles, 5,112 + 1,230 dofs; its CSV under build/stokes/), then
    with the port's own k; the same system at maxh 0.01 (17,002
    triangles, 205,740 + 51,006 dofs); the mixed pairs at maxh 0.1 (TH2,
    TH3, mini, P2-P0, P1nc-P0, P2+-P1; Jacobi) and TH2 with MINRES; each
    solve given the JAX package's Bramble-Pasciak k
    (tools/jax_stokes_reference.py), its inlet velocity held to the
    boundary values; each mixed solve held to JAX's count
    (``count_matches``) and its true residual to within a factor 2 of
    JAX's; each HDG solve, whose count roundoff decides (its
    Bramble-Pasciak form is indefinite at JAX's k), held to the head of
    JAX's error history within 1e-8 and its true residual to within a
    factor 10, the count printed beside JAX's; the MCS triple as
    scripts/stokes_hcurldiv.py runs it at maxh 0.06 (direct solve, then
    MINRES to 1e-8, which stops at its 50,000 cap in both packages: held to
    the cap and to JAX's final error and distance from the direct solution
    within 10%).  ``[heat]``: ``HeatEquation`` at the reference's literals
    (maxh 0.1, order 10: 200 triangles, 10,201 dofs), the first time
    step of the study (1 large step; once three, then two, cut to make
    room for later phases;
    tools/smoke_phases.py runs all five), each L2 error held to JAX's
    within 1e-10 of the solution's L2
    norm, the CG count of every solve and the seconds per step.  Kernel 8 is checked on every new table (HDG, mixed, MCS element
    tables, the edgeblock inverses, heat's mass and stiffness) and must
    launch in each solve; the counters are set to 0 just before each.
19. ns-sweep: the port's scripts/run_ns_sweep.py default subset through
    its ``main`` (12 initial Stokes solves of the 2D MCS model, h = 2^-3
    .. 2^-1 x order 3, 2 x GS on / off, to 1e-10; the CSV under
    build/ns_sweep/ in the JAX schema), the counters set to 0 just before
    it (kernel 8 in f64 must launch); then each configuration through
    ``solve`` with the JAX package's Bramble-Pasciak k, its count held to
    JAX's by ``count_matches`` (tools/jax_sweep_reference.py), the count
    with the port's own k printed beside it.
20. shard (run after sweep): the sharded solves of ``parallel/`` on
    torch.distributed.  World size 1: NCCL with one rank in this process
    on an in-memory store, the main path's model sharded with bench.py's
    tables (kernels 1, 2 and 8 held to their plain versions on the
    shard's tables), ``sharded_fast_flagship_solve`` with bench.py's inner
    settings to a true f64 residual <= 1e-8, its inner count within the
    JAX rule max(10, 0.1 n) of the single-device 358, the launch counters
    set to 0 just before and read after; world size 2: two gloo ranks on
    the one card (the port stages each collective through host memory),
    the dd solve of the 2D vertexstar model at maxh 0.3 and
    ([shard-face], in a process of its own during step 15) the
    face-sharded solve at maxh 0.35 with the JAX package's sharded tables
    at its sharded parity test's settings (two passes, tol 1e-6), each
    held to the JAX package's count at 2 shards
    (tools/jax_faceshard_reference.py); setup and solve seconds, inner
    iterations, passes, halo against owned face rows and collective calls
    per inner iteration printed;
21. graft: ``__graft_entry__``'s entry points as the port has them
    (``navier_stokes_tpu_torch.graft_entry``): ``entry()``'s float32 step
    of the 2D MCS model at maxh 0.25 on the card (kernel 8 must launch)
    and on the CPU from the same state, within GRAFT_STEP_BOUND, their CG
    counts within one; then, on a machine of several cards,
    ``dryrun_multichip`` over all of them (four NCCL ranks on a four-card
    one): the face-sharded 2-phase solve of the straight 3D channel at
    maxh 0.35 to 1e-8, its inner count held to the JAX package's at that
    world size (GRAFT_JAX), kernels 1, 2 and 8 launched, and the
    Taylor-Hood batch step split over the ranks.  On one card the dry run's
    spatial half at world size 1 is the same in-process NCCL solve as step
    20's world size 1, so only its data-parallel half runs here (NCCL, one
    rank in this process); ``tools/smoke_phases.py --phases graft`` runs
    the whole dry run at any card count;
22. dd3d: the dd solve's 3D branch (tests/test_parallel.py's 3D case, the
    face+interior block smoother) at maxh 0.35, world size 1 (NCCL):
    kernel 8 in f64 on the rank's A, B, B^T and block-inverse tables
    against its plain version, ``ddshard.sharded_flagship_solve`` to 1e-8
    (kernel 8 must launch) against the model's own ``SolveInitial(GS=
    False)``: both converged, counts within max(5, 0.02 n), velocities
    within 2e-3 of max |u| (the JAX test's bounds).

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
import signal
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
# [skeleton-slow]: the straight channel of tests/test_skeleton_fast.py; the
# dof-level preconditioner built on the card against the same built on the
# CPU (plain versions), all tables f64
SLOW_MAXH, SLOW_CARD_CPU = 0.35, 1e-12
# [cuda-tests]: the card-only tests, JAX-free, run from the repository alone
CUDA_TESTS = "tests/test_torch_cuda.py"
CUDA_TEST_CASES = 44  # 27 tests, 44 cases with their parameters
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
# (HDG_STEPS DoTimeSteps: 3 through PR 16, cut to 1 to make room for
# [shard])
HDG_MAXH, HDG_MAXSTEPS, HDG_STEPS = 0.09, 20000, 1
# [mcs2d] / [th2d]: the 2D demo (the reference's NavierStokesSIMPLE_test.py
# through scripts/navier_stokes_2d.py): the channel with cylinder at
# maxh 0.05 (762 triangles), order 2, nu 1e-3, dt 1e-3, the auxspace GS
# A-preconditioner, SolveInitial to 1e-10, then MCS2D_STEPS f64 steps
# (20 through PR 16, cut to make room for [shard]); the MCS model again at
# maxh 0.01 (17,002 triangles)
MCS2D_MAXH, MCS2D_FINE, MCS2D_TOL, MCS2D_STEPS = 0.05, 0.01, 1e-10, 5
# the JAX package's MCS count and Bramble-Pasciak k there, on the CPU in
# f64 (tools/jax_bpcg_reference_2d.py; 172 with one BLAS thread and with
# eight; the port on the CPU with that k: 172).  The port solves with that
# k and is held to the count by count_matches: equal, or, where the
# card's sums put the error at the JAX count just past the threshold
# (within a factor 1.5 of it), at most MCS2D_PLATEAU more -- the error
# history plateaus there: on the CPU the port with its own k, 1e-11 off
# JAX's, reads 1.109e-10 at 172, then 1.210e-10, 1.691e-10, 1.303e-10
# and stops at 176 (8.330e-11)
MCS2D_JAX = {MCS2D_MAXH: (172, 26.24155445117038),
             # maxh 0.01: 220.6 s on the CPU
             MCS2D_FINE: (662, 400.87853032198007)}
MCS2D_PLATEAU = 4
# the Taylor-Hood count and k there (tools/jax_bpcg_reference_2d.py --th)
TH2D_JAX = (126, 1.711092508702795)
# [stokes] / [heat]: the Stokes catalog at the reference's sizes
# (scripts/run_stokes.py, scripts/stokes_hcurldiv.py) and the heat model at
# the reference's literals (scripts/run_heat.py)
STOKES_TOL, STOKES_MAXSTEPS, STOKES_PLATEAU = 1e-7, 10000, 4
STOKES_MAXH, STOKES_FINE, MCS_MAXH = 0.1, 0.01, 0.06
# the JAX package's figures on the CPU in f64 (tools/jax_stokes_reference.py)
# per solve: (count, Bramble-Pasciak k, true relative residual at the
# solution, its error history at iterations 10, 20, 30 or None).  The port
# solves with that k.  The mixed solves are held to the count by
# count_matches and to the true residual within STOKES_RES_FACTOR (their
# counts equal JAX's on 1, 2, 4 and 8 CPU threads).  The HDG solves are
# not: at JAX's k their Bramble-Pasciak form is indefinite (rho < 0 at 8
# of the 742 iterations at maxh 0.1, at 72 of 5,610 at 0.01) and the
# stopping test sqrt|rho| < tol is decided by roundoff -- at maxh 0.1 the
# port reads 742 on 1, 4 and 8 CPU threads and 574 on 2 (true residual
# 3.97e-4, JAX's 1.04e-4); at 0.01 5,610 on 4 CPU threads and 5,206 on the
# card, where JAX reads 5,293.  They are held to the head of JAX's error
# history within STOKES_HEAD_TOL (before roundoff parts the two
# iterations: 1e-11 apart at iteration 30 on the CPU), to convergence and
# to a true residual within STOKES_HDG_RES_FACTOR of JAX's (3.8 and 4.2
# times it in the two early stops seen); the count is printed
STOKES_HDG_JAX = {
    STOKES_MAXH: (742, 375.6217354993172, 1.0389046064492299e-04,
                  {10: 0.003686898597745731, 20: 0.0008079561640962657,
                   30: 0.0006035949908023865}),
    # maxh 0.01: 138-149 s of BPCG on the CPU
    STOKES_FINE: (5293, 467.6351552864316, 1.3747435331407066e-04,
                  {10: 0.007900375429870958, 20: 0.002022812031121947,
                   30: 0.0011456802069514736})}
STOKES_MIXED_JAX = {
    "taylor hood 2": (268, 102.03653457734538, 1.7450566541873335e-07, None),
    "taylor hood 3": (503, 196.97768165621892, 7.289699680133806e-07, None),
    "mini": (158, 20.9315008249787, 7.28922920848893e-08, None),
    "P2, P0": (355, 102.03653457734538, 1.7859467553748402e-07, None),
    "P1nc, P0": (405, 83.49157634201809, 1.5581604477491897e-07, None),
    "P2+, P1": (392, 81.07783223211216, 3.0633587174639774e-06, None)}
# Taylor-Hood 2 with block-preconditioned MINRES (no k)
STOKES_MINRES_JAX = (279, None, 1.0701715975517797e-07, None)
STOKES_RES_FACTOR, STOKES_HDG_RES_FACTOR, STOKES_HEAD_TOL = 2.0, 10.0, 1e-8
# MCS MINRES at maxh 0.06 (1e-8, at most 50,000 steps): the Jacobi
# preconditioner (1 on the zero velocity diagonal) does not reach the
# tolerance in either package; the JAX package stops at the cap with a
# relative error of 2.459e-3, 297.7 off the direct solution at its worst
# dof (the port on the CPU: 2.442e-3 and 297.65).  The port is held to the
# cap and to those two within MCS_BAND
MCS_JAX = dict(iterations=50000, final_error=0.0024594948320921114,
               max_diff_direct=297.69703229027084)
MCS_MAXSTEPS, MCS_BAND = 50000, 0.10
# HeatEquation(maxh 0.1, order 10, 10 Gauss stages, subspace 5, CG to
# 1e-13): the L2 errors of the first five time steps of the study (end
# time 0.05) on the CPU in f64.  [heat] runs the first HEAT_RUN of them
# (1 large step, about 15,700 CG iterations; once 3 of them, 8 large
# steps, cut to 2 to make room for [shard] and to 1 for [probes] and
# [skeleton-slow]): the inner CG is host-bound on
# the card (one host read and about 27 launches per iteration: 0.36-0.43
# ms on one host, 0.49-0.62 on another), so that the five took 170.8 s
# and the fourth's 16 steps alone 72.5 s; `python3 tools/smoke_phases.py
# --heat-steps 5` runs all five, and scripts/run_heat.py the whole study
# with dt 3.16e-4 and 1e-4 (659 more steps).  Each error is held to JAX's
# within
# HEAT_TOL times the exact solution's L2 norm at the final time: the
# states of the two packages agree to about 1e-12 (each CG stops at a
# relative 1e-13 at its own iterate), and an error can move by no more
# than the state does.  Relative to the error itself the two part by
# 3.2e-8 at dt 0.01 already (the port on the CPU against JAX), and the
# error at dt 0.001, 1.1e-8, lies 14 orders below the state
HEAT_STEPS = (0.1, 0.03162277660168379, 0.01, 0.0031622776601683794, 0.001)
HEAT_JAX = (0.004531476446483092, 0.00017125506665474163,
            1.2568817807744234e-05, 1.1420201716659314e-07,
            1.121995294735825e-08)
HEAT_TOL, HEAT_RUN = 1e-10, 1
# [sweep]: the 3D MCS Reynolds-number ensemble (parallel/sweep.py, the JAX
# package's BASELINE config 5) on the curved f64 model at maxh 0.09: one
# member per viscosity of geomspace(1e-3, 1e-2, SWEEP_MEMBERS), SWEEP_STEPS
# fused steps each, from the flagship solution; the member at the model's
# nu held to DoTimeStep within SWEEP_DTS_TOL of max |u| (the JAX test's
# bound, tests/test_sweep_checkpoint.py).  The run takes every
# SWEEP_EVERY-th member (0 and 4 of the 8: the cut that makes room for
# [shard]; all 8 through PR 16)
SWEEP_MEMBERS, SWEEP_STEPS, SWEEP_DTS_TOL = 8, 2, 1e-6
SWEEP_EVERY = 4
# the same ensemble on the straight channel of that JAX test at maxh 0.35
# (order 2, dt 2e-3) from u = u_bc, with the JAX model's Chebyshev bounds
# and the JAX host's element-interior BDM_2 functions
# (SWEEP_SMALL_BASES, carried_cell_bases), held to the JAX package's
# numbers (tools/jax_sweep_reference.py on the CPU in f64): per member
# max |u|, ||u_i - u_0||, ||u_i - u_bc|| and the M* and projection CG
# counts of each step.  Without the carried functions the card's host
# (another LAPACK) takes another orthonormal basis of each element's
# six-dimensional interior null space, and the states lie 1.7e-2 apart
# (tools/sweep_card_vs_cpu.py)
SWEEP_SMALL_MAXH = 0.35
SWEEP_SMALL_BASES = os.path.join("tools", "jax_bdm2_cell_bases.npz")
SWEEP_SMALL_JAX = dict(
    ndof=102576, cheb_bounds=(0.1336248977269488,
                              6.68124488634744),
    members=[
        dict(max_abs_u=10.037244925055505, dist_u0=0.0,
             dist_u_bc=17.470376416239997, mstar=[91, 92],
             project=[150, 149]),
        dict(max_abs_u=9.703415978157475, dist_u0=0.6591457529609471,
             dist_u_bc=17.043207389478034, mstar=[99, 102],
             project=[150, 149]),
        dict(max_abs_u=9.262849001644401, dist_u0=1.5206994604736686,
             dist_u_bc=16.50003099728027, mstar=[103, 109],
             project=[150, 149]),
        dict(max_abs_u=8.692012602918108, dist_u0=2.6305408503562844,
             dist_u_bc=15.834163819331243, mstar=[109, 122],
             project=[149, 149]),
        dict(max_abs_u=7.972025012714793, dist_u0=4.030460091291821,
             dist_u_bc=15.061409996816947, mstar=[116, 132],
             project=[149, 148]),
        dict(max_abs_u=7.089803340399039, dist_u0=5.752936843090225,
             dist_u_bc=14.240196645414956, mstar=[127, 145],
             project=[149, 148]),
        dict(max_abs_u=6.047427177612203, dist_u0=7.805872604331231,
             dist_u_bc=13.495437509275584, mstar=[134, 160],
             project=[149, 148]),
        dict(max_abs_u=4.873802067509958, dist_u0=10.169616050631918,
             dist_u_bc=13.031019941171799, mstar=[144, 175],
             project=[149, 148])])
# the bounds at the step's own M* CG stop (1e-4), relative for the three
# magnitudes, absolute for the CG counts.  Two sound runs part there: the
# CG paths separate after some 80 iterations and each stops within its
# 1e-4, so the states differ by up to 1.4e-4 of their norm (the port on
# the card against the port on the CPU, the same basis); the CPU port reads
# JAX's max |u| within 8.9e-6, ||u_i - u_0|| 4.7e-4 (member 1 lies 0.66
# from member 0 in a norm of 17), ||u_i - u_bc|| 3.4e-6, counts 1 apart
# (members 0, 1, 7), the card 2.5e-6, 3.8e-5, 7.9e-6 and 2 apart (all
# eight).  The float32 control lands inside that spread (3.5e-6 to 6.5e-6
# in max |u|): this comparison is coarse, the one below is the sharp one
SWEEP_SMALL_TOL = dict(max_abs_u=1e-4, dist_u0=5e-3, dist_u_bc=1e-4,
                       count=4)
# the same ensemble with the M* CG to SWEEP_TIGHT_CG, where its stop no
# longer decides the states: the JAX package's numbers
# (tools/jax_sweep_reference.py --mstar-tol 1e-10) and the bounds.  The
# card read them within 1.0e-10 (||u_i - u_0||; max |u| 1.3e-11, ||u_i -
# u_bc|| 5.9e-12) and the counts 3 apart; the control, the step's nu-split
# and mass applies in float32 as before the repair of elem_apply_multi,
# lies 3.9e-8 to 3.5e-6 away (members 0, 1, 7; 2.0e-6 on member 1)
# (tools/sweep_card_vs_cpu.py, tools/smoke_phases.py; NVIDIA H100 80GB
# HBM3, 700 W).  SWEEP_CONTROL runs that control on one member and must
# break the bound
SWEEP_TIGHT_CG, SWEEP_CONTROL = 1e-10, 1
SWEEP_TIGHT_JAX = [
    dict(max_abs_u=10.037272450821524, dist_u0=0.0,
         dist_u_bc=17.470756842713644, mstar=[367, 513],
         project=[150, 149]),
    dict(max_abs_u=9.702972368009185, dist_u0=0.6572977516222251,
         dist_u_bc=17.043819062559653, mstar=[387, 546],
         project=[150, 149]),
    dict(max_abs_u=9.262472471052567, dist_u0=1.5184641960331637,
         dist_u_bc=16.500692508376012, mstar=[414, 586],
         project=[150, 149]),
    dict(max_abs_u=8.692533295349513, dist_u0=2.6277438893753287,
         dist_u_bc=15.834658029670496, mstar=[452, 643],
         project=[149, 149]),
    dict(max_abs_u=7.9722464484787094, dist_u0=4.027293327399635,
         dist_u_bc=15.061582333956736, mstar=[486, 693],
         project=[149, 148]),
    dict(max_abs_u=7.089322344908918, dist_u0=5.74832800636092,
         dist_u_bc=14.23984473443473, mstar=[518, 777],
         project=[149, 148]),
    dict(max_abs_u=6.047589867694507, dist_u0=7.801069465563427,
         dist_u_bc=13.495268429771464, mstar=[585, 868],
         project=[149, 148]),
    dict(max_abs_u=4.874105926099992, dist_u0=10.165318712425485,
         dist_u_bc=13.030731117560205, mstar=[638, 967],
         project=[149, 148])]
SWEEP_TIGHT_TOL = dict(max_abs_u=1e-9, dist_u0=1e-9, dist_u_bc=1e-9,
                       count=6)
# [ns-sweep]: scripts/run_ns_sweep.py's default subset (the 2D MCS model,
# h = 2^-3..2^-1 x order 3, 2 x GS on / off, tol 1e-10): the JAX package's
# count and Bramble-Pasciak k per (h, order, GS), on the CPU in f64
# (tools/jax_sweep_reference.py --parts ns-sweep); the port solves with
# that k and is held to the count by count_matches (MCS2D_PLATEAU)
# [shard]: the sharded solves of parallel/ (faceshard.py, ddshard.py) on
# torch.distributed.  World size 1: NCCL, one rank in this process on an
# in-memory store, the main path's model at MAXH with bench.py's table
# settings and inner settings (the first pass's inner tol 5e-7, 800
# iterations per pass; the 2-phase driver), to a true f64 residual <= TOL,
# its inner count held to the single-device flagship solve's 358 by the JAX
# package's rule |d| <= max(10, 0.1 n) (tests/test_faceshard.py).  World
# size 2: two gloo ranks on the one card (NCCL refuses two ranks on one
# GPU; the port stages each collective's CUDA tensors through host memory
# itself): the dd solve of the 2D vertexstar model at SHARD_DD_MAXH with
# the JAX package's k, held within 3 of the JAX package's count at 2
# shards; and [shard-face], the JAX package's sharded tables (f32, coarse
# target 0.9, as computed) at SHARD_SMALL_MAXH, MULTICHIP_r05's size, with
# the JAX host's element-interior functions (SWEEP_SMALL_BASES), at the
# settings of the JAX package's sharded parity test (SHARD_SMALL_KW,
# tests/test_faceshard.py: two refinement passes), held to the JAX
# package's count at 2 shards by the same rule as world size 1
# (tools/jax_faceshard_reference.py on the CPU, runs card and dd).  Its
# 60-115 s are staged host exchanges, so it runs in a process of its own
# (tools/smoke_phases.py --phases shard-face) beside [amg]'s host setup,
# and is waited for before [amg]'s first timed solve
SHARD_MAIN_INNER = 358
SHARD_INNER = dict(inner_tol=5e-7, inner_maxsteps=800)
SHARD_BENCH_TABLES = dict(symmetrize=True, coarse_target=1.6)
SHARD_SMALL_MAXH, SHARD_DD_MAXH, SHARD_RANKS = 0.35, 0.3, 2
SHARD_SMALL_KW = dict(tol=1e-6, inner_tol=5e-7, inner_maxsteps=800,
                      two_phase=False)
SHARD_JAX = dict(
    face=dict(inner=628, passes=2, rel=2.6284053809188047e-08,
              halo_rows=(2377, 530), own_rows=(3744, 3214)),
    dd=dict(iterations=311, scale_k=35.6798441458756, tol=1e-9))
SHARD_DD_DIFF = 1e-6  # velocity against the single-device SolveInitial
# [graft]: __graft_entry__'s entry points (navier_stokes_tpu_torch.
# graft_entry).  entry()'s float32 step of the 2D MCS model at maxh 0.25 on
# the card and on the CPU (plain versions) from one state, within
# GRAFT_STEP_BOUND of max |u| (kernel 8 and its plain version sum in
# different orders; tests/test_torch_graft_entry.py holds the port to the
# JAX package within 1e-6 on the CPU), the M* and projection CG counts
# within one of each other.  Then
# dryrun_multichip(torch.cuda.device_count()): the face-sharded 2-phase
# solve of the straight 3D channel at maxh 0.35 to 1e-8 (with the JAX
# host's element-interior functions, SWEEP_SMALL_BASES), its inner count
# held by shard_match to the JAX package's at the same world size
# (tools/jax_faceshard_reference.py --parts graft --graft-shards 1,4, the
# JAX package on 1 and 4 virtual CPU devices; 125 s and 155 s there), and
# the Taylor-Hood batch step split over the ranks, on four NCCL ranks on a
# four-card machine.  On one card chip_smoke.py runs the batch step alone
# (NCCL, one rank in this process): the spatial half at world size 1 is
# [shard]'s world-size-1 solve on another model, and
# tools/smoke_phases.py --phases graft runs it (GRAFT_JAX[1])
GRAFT_STEP_BOUND = 1e-5
GRAFT_JAX = {
    1: dict(inner=991, passes=(3, 0), rel=1.9197279511821796e-12,
            halo_rows=(0,), own_rows=(6958,)),
    4: dict(inner=974, passes=(3, 0), rel=1.6810812163700603e-12,
            halo_rows=(1688, 1919, 643, 764),
            own_rows=(1960, 1784, 1695, 1519)),
}
# [dd3d]: tests/test_parallel.py's 3D dd case (the straight channel at maxh
# 0.35, order 2, the faceblock preconditioner, float64): the dof-sharded
# BPCG solve (ddshard.sharded_flagship_solve) at world size 1 (NCCL, this
# process) to DD3D_TOL against the model's own SolveInitial(GS=False) to
# the same tol, with the JAX test's bounds: both converged, the counts
# within max(5, 0.02 n), the sharded velocity within DD3D_DIFF of max |u|.
# The JAX package's counts beside them (tools/jax_faceshard_reference.py
# --parts dd3d): 2,079 single; 2,278 sharded on 1 virtual device, whose
# Lanczos k (244.637) starts from a random vector of the padded sharded
# length -- outside its own 2% band there; 8.95e-4 of max |u| apart
DD3D_MAXH, DD3D_TOL, DD3D_MAXSTEPS, DD3D_DIFF = 0.35, 1e-8, 6000, 2e-3
DD3D_JAX = dict(single=2079, sharded=2278, scale_k=244.63652753521004,
                diff=0.0008951549643574789)
NS_SWEEP_TOL = 1e-10
NS_SWEEP_JAX = {
    (0.125, 3, True): (138, 14.443043112317604),
    (0.125, 3, False): (167, 2.0864794575080667),
    (0.125, 2, True): (133, 14.434535981319161),
    (0.125, 2, False): (173, 2.789604529412123),
    (0.25, 3, True): (152, 16.0003005158995),
    (0.25, 3, False): (201, 3.3218083084411996),
    (0.25, 2, True): (144, 15.994408900773562),
    (0.25, 2, False): (210, 4.704076255748117),
    (0.5, 3, True): (167, 17.46316570914815),
    (0.5, 3, False): (283, 7.702861182173656),
    (0.5, 2, True): (172, 19.18802715154167),
    (0.5, 2, False): (289, 8.641780912446647)}
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
# kernel 8 on rectangular blocks, as the CPU tests (ne, nout, nin, offset):
# the dd solve's B and B^T shapes, a CTA's rows over many elements or a
# part of one, odd widths, views off a 16-byte boundary
EDGE_RECT = ((300, 4, 54, 0), (300, 54, 4, 0), (77, 13, 5, 0),
             (5, 1, 130, 0), (3, 130, 1, 0), (300, 4, 54, 1),
             (77, 5, 13, 3), (301, 54, 4, 2))
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


class carried_cell_bases:
    """Within: every BDM_2 tetrahedron basis the port builds takes its
    element-interior functions from ``path`` (the JAX package's host,
    tools/jax_sweep_reference.py --parts bases).  They are an orthonormal
    basis of the SVD null space of the face moments, which is six-
    dimensional: another host's LAPACK may return another rotation of it,
    and the dof vectors and Jacobi-preconditioned solves of a model would
    differ from JAX's by that alone.  ``off_span``: how far the carried
    functions lie from the port's own null space (must be roundoff);
    ``apart``: how far they are from the port's own functions."""

    def __init__(self, path):
        import numpy as np

        data = np.load(path)
        self.order = int(data["order"])
        self.table = {tuple(tuple(int(p) for p in f) for f in combo): cells
                      for combo, cells in zip(data["combos"], data["cells"])}
        self.combos, self.off_span, self.apart = 0, 0.0, 0.0

    def __enter__(self):
        import dataclasses

        import numpy as np

        from navier_stokes_tpu_torch.fem import hdiv3d

        self.hdiv3d, own = hdiv3d, hdiv3d.bdm_tet
        self.own = own

        def carried(order, combo):
            b = own(order, combo)
            if order != self.order:
                return b
            cells = self.table[tuple(tuple(int(p) for p in f)
                                     for f in combo)]
            mine = b.coeffs[b.n_basis - b.n_cell:]  # orthonormal rows
            off = cells - (cells @ mine.T) @ mine
            self.off_span = max(self.off_span, float(np.abs(off).max()))
            self.apart = max(self.apart, float(np.abs(cells - mine).max()))
            self.combos += 1
            return dataclasses.replace(b, coeffs=np.concatenate(
                [b.coeffs[:b.n_basis - b.n_cell], cells]))

        hdiv3d.bdm_tet = carried
        return self

    def __exit__(self, *exc):
        self.hdiv3d.bdm_tet = self.own
        return False


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
    f64; ``batched_local_matvec_rect`` on a rectangular (ne, nout, nin)
    one) against its plain version: within 2e-6 (f32) or 1e-13 (f64) of
    sum_j |a_ij u_j|.  The bound counts the table, u and y as they are.
    The yardstick is one ``torch.bmm``."""
    ne, nout, nin = A.shape
    f64 = A.dtype == torch.float64
    mv = (lm.batched_local_matvec if nout == nin
          else lm.batched_local_matvec_rect)
    u = torch.randn((ne, nin), generator=gen, device="cuda", dtype=A.dtype)
    y = mv(A, u)
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
    ms = timer(lambda: mv(A, u))
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
    * kernel 8 on ``EDGE_LOCAL`` (square) and ``EDGE_RECT`` (rectangular)
      in both types, on views that start 0, 4, 8 or 12 bytes past a
      16-byte boundary, within 2e-6 (f32) or 1e-13 (f64) of
      sum_j |a_ij u_j| of its plain version."""
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
        for ne, nout, nin, off in ([(ne, nb, nb, off)
                                    for ne, nb, off in EDGE_LOCAL]
                                   + list(EDGE_RECT)):
            def view(*shape):
                n = int(np.prod(shape))
                flat = torch.as_tensor(rng.standard_normal(off + n),
                                       device="cuda").to(dt)
                return flat[off:].view(shape)

            A, u = view(ne, nout, nin), view(ne, nin)
            y = (lm.batched_local_matvec if nout == nin
                 else lm.batched_local_matvec_rect)(A, u)
            d = (y - lm.batched_local_matvec_plain(A, u)).abs().double()
            scale = torch.einsum("eij,ej->ei", A.double().abs(),
                                 u.double().abs()).clamp_min(1e-300)
            worst = float((d / scale).max())
            tol = 1e-13 if dt == torch.float64 else 2e-6
            check(bool(torch.isfinite(y).all()) and worst <= tol,
                  f"batched_local_matvec {(ne, nout, nin)} {str(dt)[6:]} at "
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
        f"batched_local_matvec on {n8} tables (square and rectangular) "
        "within tolerance")


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
        # a record_function range (the program's ns: spans) has a device
        # row of its own that spans its kernels
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
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


# processes this script started; main() ends any still running
CHILDREN = []


def cuda_tests_start(here):
    """Start ``python -m pytest --noconftest -m cuda`` on the JAX-free
    card-test file, from the repository root, in the background; returns
    (process, start time) for :func:`cuda_tests_phase`."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
           CUDA_TESTS, "-q", "-p", "no:cacheprovider"]
    proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    CHILDREN.append(proc)
    return proc, time.perf_counter()


def cuda_tests_phase(here, started=None):
    """[cuda-tests]: the card tests (started here, or the ``started``
    (process, start time) of :func:`cuda_tests_start`), waited for; every
    case must pass (none skipped).  Returns the seconds since the start."""
    import re

    proc, t0 = started or cuda_tests_start(here)
    stdout, stderr = proc.communicate(timeout=900)
    secs = time.perf_counter() - t0
    lines = stdout.strip().splitlines()
    tail = lines[-1] if lines else ""
    log(f"[cuda-tests] python -m pytest --noconftest -m cuda {CUDA_TESTS}: "
        f"rc {proc.returncode}, {tail} ({secs:.1f} s since its start)")
    passed = re.search(r"(\d+) passed", tail)
    ok = (proc.returncode == 0 and passed is not None
          and int(passed.group(1)) == CUDA_TEST_CASES
          and not re.search(r"failed|error|skipped|xfail|xpass", tail))
    if not ok:
        for line in (lines + stderr.strip().splitlines())[-60:]:
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
    block-inverse tables against its plain version, and a solve with the
    JAX package's scaling k, whose count is held to JAX's.  ``m.u`` and
    ``m.p`` are put back."""
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
        # the JAX k alone: the solve with the port's own k (937 / 740
        # iterations, printed only) was cut to make room for [probes] and
        # [skeleton-slow]; the curved solve above takes its own k
        for which, k in (("JAX k", jax_k),):
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


def check_probe_rows(rows, tag):
    """``scripts/probe_transient``'s rows on the card: every single apply's
    graph replay took time, and the standalone M* and projection CG counts
    equal the step's own."""
    check(all(r["replay_ms"] > 0 for r in rows if "replay_ms" in r),
          f"{tag} a piece's graph replay took no time")
    in_step = next(r for r in rows if r["piece"] == "in-step counts")
    for r in rows:
        if "iterations" in r:
            key = "mstar" if r["piece"].startswith("mstar") else "project"
            check(r["iterations"] == in_step[key], f"{tag} {r['piece']} "
                  f"took {r['iterations']}, the step {in_step[key]}")


def transient_phase(torch, bm, m, step, m64, u64_start):
    """bench.py's second metric on the port: the f32 SIMPLE step ``step`` of
    the stepping model ``m``, then 3 f64 steps of ``m64`` from the flagship
    solution.  Returns the launch counts of one (the cold) f32 step and of
    the first f64 step."""
    from navier_stokes_tpu_torch.flagship import transient_steps
    from navier_stokes_tpu_torch.scripts import probe_transient
    from navier_stokes_tpu_torch.utils.timers import host_ms

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

    # what the projection does to ||B u||
    _, v, _ = projection_check(torch, m, u, "[transient]")
    log(f"[transient] ||B u|| after the steps {norm(m.B_raw(u)):.3e}, of "
        f"u_bc {norm(m.B_raw(u0)):.3e}")

    # the pieces of one step: scripts/probe_transient's own harness (JAX
    # names, graph replay and eager ms, the CG counts), then the projection
    # as the step calls it
    rows = probe_transient.probe(m, u, step,
                                 log=lambda line: log("[piece f32]" + line))
    check_probe_rows(rows, "[transient]")
    ms = host_ms(lambda: m._project_velocity(v, tol=PROJECT_TOL32))
    log(f"[piece f32]   {'project (CG 1e-5)':34s} {ms:10.1f} ms (host clock,"
        " median of 3)")

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
    """The ported microbenchmark scripts at full width.  microbench_dma and
    microbench_apply2 with the launch counters set to 0 just before: each
    of the five table-stream wrappers must have launched.  Then
    microbench_apply and microbench_apply3 at maxh 0.09, the counters set
    to 0 again: kernels 1, 2 and 8 (f32) must launch, every line must be
    timed, and each script raises where a deviation leaves its bound
    (TF32 on and off for microbench_apply's library line).  Returns the
    launch counts of the first two scripts."""
    from navier_stokes_tpu_torch.scripts import (
        microbench_apply,
        microbench_apply2,
        microbench_apply3,
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

    bm.reset_launches()
    log(f"[microbench] scripts.microbench_apply.main({MAXH})")
    rows3 = microbench_apply.main(MAXH)
    log(f"[microbench] scripts.microbench_apply3.main({MAXH})")
    rows4 = microbench_apply3.main(MAXH)
    launches2 = dict(bm.LAUNCHES)
    log(f"[microbench] microbench_apply[3] launches {launches2}")
    check(all(r["ms"] is not None and r["ms"] > 0 and r["graph_ms"] > 0
              for r in rows3 + rows4),
          "[microbench] a microbench_apply[3] line was not timed")
    for name in ("block_mv", "block_mv2", "batched_local_matvec"):
        check(launches2[name] > 0, f"{name} never launched in "
              "microbench_apply[3]")
    for r in rows3:
        check(r["dev"] is None or r["dev"] <= r["bound"],
              f"[microbench] {r['label']} ({r['precision']}): {r['dev']}")
    check(all(r["dev"] is None or r["dev"] <= microbench_apply2.DEV_TOL
              for r in rows4), "[microbench] microbench_apply3 deviates")
    lib = {r["precision"]: r["graph_ms"] for r in rows3
           if r["label"] == "einsum only"}
    log(f"[microbench] einsum only (bmm) chained: TF32 on {lib['default']:.4f}"
        f" ms, off {lib['highest']:.4f} ms")
    return launches


def amg_phase(torch, bm, build_model, FlagshipSolve, cylinder_geometry,
              shard_face=None):
    """The SA-AMG coarse solve on a mesh whose P1 coarse spaces exceed the
    dense limit of 5,000 free vertices: (a) AMG-preconditioned CG on the P1
    stiffness, (b) the curved GS flagship solve cold and warm, (c) one cold
    and three warm f32 transient steps.  ``shard_face``: the started
    [shard-face] process (:func:`shard_face_start`), which runs beside (a)
    and (b)'s host setup (their seconds are marked so) and is waited for
    before (b)'s first solve.  Returns :func:`shard_face_wait`'s (seconds,
    waited), or None."""
    import numpy as np

    from navier_stokes_tpu_torch.fem.spaces import H1
    from navier_stokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_mesh_3d,
    )
    from navier_stokes_tpu_torch.ops import assembly as asm
    from navier_stokes_tpu_torch.precond.amg import build_sa_amg
    from navier_stokes_tpu_torch.solvers.cg import cg

    beside = " (beside [shard-face])" if shard_face else ""
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
    log(f"[amg] (a) build_sa_amg {t_amg:.1f} s{beside}, {pre.levels} ELL "
        f"levels; PCG to 1e-8 in {res.iterations} iterations (plain CG "
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
        f"{m.Q.ndof}; model build {t_model:.1f} s, GS ops {t_ops:.1f} "
        f"s{beside}, {len(parts['groups'])} colors, coarse AMG levels "
        f"{parts['coarse_amg_levels']}, coarse lambda "
        f"{parts['coarse_lambda']:.4f}")
    check(parts["coarse_amg_levels"] >= 1,
          "[amg] the skeleton preconditioner took the dense coarse inverse")
    face = shard_face_wait(shard_face) if shard_face else None
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
    return face


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
    equal ([repeat]); HDG_STEPS ``DoTimeStep``s (finite; steps/s, CG
    counts);
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
    for _ in range(HDG_STEPS):
        m.DoTimeStep()
        counts.append(dict(m.last_iterations))
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    step_launches = dict(bm.LAUNCHES)
    path_launches = {k: solve_launches.get(k, 0) + step_launches.get(k, 0)
                     for k in set(solve_launches) | set(step_launches)}
    finite = bool(torch.isfinite(m.u).all())
    log(f"[hdg3d] {HDG_STEPS} DoTimeSteps in {t_steps:.3f} s "
        f"({HDG_STEPS / t_steps:.3f} steps/s), CG counts {counts}, max |u| "
        f"{float(m.u.abs().max()):.4f}, ||B u|| "
        f"{float(torch.linalg.norm(m.B_raw(m.u))):.3e}; launches per step "
        + str({k: v / HDG_STEPS for k, v in step_launches.items() if v}))
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

def count_matches(res, n_jax, tol, plateau):
    """Whether a BPCG count given the JAX k agrees with the JAX count
    ``n_jax``: equal; or one fewer, the card's error there within a
    factor 1.5 under ``tol``; or up to ``plateau`` more, the card's error
    at ``n_jax`` within a factor 1.5 over ``tol`` (the stopping test sits
    on the threshold, and the sums' order decides it).  Returns (ok, the
    card's errors around n_jax)."""
    err = [float(e) for e in res.errors[max(n_jax - 2, 0):n_jax + plateau + 1]]
    n = res.iterations
    if n == n_jax:
        return True, err
    if n == n_jax - 1:
        return tol / 1.5 <= float(res.errors[n]) < tol, err
    e = float(res.errors[n_jax])
    return n_jax < n <= n_jax + plateau and tol <= e <= 1.5 * tol, err


def th_true_rel(torch, m):
    """The true relative residual of the Taylor-Hood model's initial Stokes
    system at its state (u, p), through its f64 operators."""
    fr = m.free_s[None]
    f_mod = torch.where(fr, m.f - m._stokesA_raw(m.u_bc), 0.0).reshape(-1)
    u_bc = m.u_bc.reshape(-1)
    g_mod = -m.B_raw(u_bc)
    du = m.u - u_bc
    r0 = f_mod - m.A(du) - m.BT(m.p)
    r1 = g_mod - m.B(du)
    return float(torch.sqrt(torch.dot(r0, r0) + torch.dot(r1, r1))
                 / torch.sqrt(torch.dot(f_mod, f_mod)
                              + torch.dot(g_mod, g_mod)))


def steps_2d(torch, bm, m, n, label):
    """``n`` DoTimeSteps of the 2D model ``m`` after one untimed step (the
    lazy setup), with the launch counters set to 0 just before them:
    seconds, steps/s, CG counts (all below maxsteps), finite state,
    launches."""
    m.DoTimeStep()
    torch.cuda.synchronize()
    counts = []
    bm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        m.DoTimeStep()
        counts.append(dict(m.last_iterations))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(bm.LAUNCHES)
    finite = bool(torch.isfinite(m.u).all())
    ms = [c["mstar"] for c in counts]
    pj = [c["project"] for c in counts]
    log(f"{label} {n} DoTimeSteps in {secs:.3f} s ({n / secs:.2f} steps/s), "
        f"M* CG {min(ms)}-{max(ms)}, projection CG {min(pj)}-{max(pj)}, "
        f"max |u| {float(m.u.abs().max()):.4f}, ||B u|| "
        f"{float(torch.linalg.norm(m.B_raw(m.u))):.3e}; launches per step "
        f"{dict((k, v / n) for k, v in launches.items() if v)}")
    check(finite, f"{label} the steps blew up")
    check(max(ms) < 2000 and max(pj) < 500, f"{label} a CG ran into "
          "maxsteps")
    return secs, launches


def mcs2d_phase(torch, bm, lm, timer, gen, reports):
    """[mcs2d]: the 2D ``NavierStokesMCS`` at the demo's configuration
    (``MCS2D_MAXH``): setup seconds; kernel 8 on the f64 A_cond, mass,
    projection-block and every GS color's vertex-star inverse table against
    its plain version; ``SolveInitial(iterative=True, GS=True, tol=1e-10)``
    with the JAX package's k (its count held to ``MCS2D_JAX`` by
    :func:`count_matches`) and with its own; the true f64 residual;
    [repeat]: two f64 steps from the same state bitwise equal; MCS2D_STEPS
    ``DoTimeStep``s.  The launch counters are set to 0 just before the
    solve and read after the steps (kernel 8 must launch in both).  Then
    the same at ``MCS2D_FINE`` (its count held to JAX's there too).
    Returns (seconds, launches of the ``MCS2D_MAXH`` path)."""
    from navier_stokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_mesh,
    )
    from navier_stokes_tpu_torch.models import NavierStokesMCS
    from navier_stokes_tpu_torch.scripts.navier_stokes_2d import uin

    t_phase = time.perf_counter()
    rep64 = reports["batched_local_matvec_f64_mcs2d"]
    kw = dict(nu=NU, inflow="inlet", outflow="outlet", wall="wall|cyl",
              uin=uin, timestep=1e-3, order=ORDER, device="cuda")
    path_launches = {}
    for maxh in (MCS2D_MAXH, MCS2D_FINE):
        tag = f"[mcs2d] maxh={maxh}"
        t0 = time.perf_counter()
        mesh = channel_with_cylinder_mesh(maxh)
        t_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        m = NavierStokesMCS(mesh, **kw)
        torch.cuda.synchronize()
        t_model = time.perf_counter() - t0
        t0 = time.perf_counter()
        preA = m._preA_for(True)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        groups = preA.gs.groups
        widths = [g[2].shape[1] for g in groups]
        log(f"{tag}: {mesh.ne} triangles, {mesh.nv} vertices, ndof "
            f"{m.n}+{m.Q.ndof}; mesh {t_mesh:.1f} s, model {t_model:.1f} s, "
            f"auxspace GS preconditioner {t_pre:.1f} s ({len(groups)} "
            f"colors, {sum(g[2].shape[0] for g in groups)} vertex stars of "
            f"up to {max(widths)} dofs)")
        if maxh == MCS2D_MAXH:
            check(mesh.ne == 762 and m.n == 8286 and m.Q.ndof == 2286,
                  f"{tag}: unexpected size {mesh.ne}, {m.n}+{m.Q.ndof}")
        pre2 = m._pre_proj_twolevel()
        tables = [("A_cond", m._A_cond), ("M_loc", m._M_loc),
                  ("S_inv", pre2.S_inv)]
        tables += [(f"star color {i}", g[2]) for i, g in enumerate(groups)]
        for tname, A in tables:
            check_local_mv(torch, lm, timer, rep64 if maxh == MCS2D_MAXH
                           else None, f"mcs2d {maxh} {tname}", A, gen)

        n_jax, k_jax = MCS2D_JAX[maxh]
        for kname, k in (("JAX k", k_jax), ("own k", None)):
            bm.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = m.SolveInitial(iterative=True, GS=True, tol=MCS2D_TOL,
                                 scale_k=k)
            torch.cuda.synchronize()
            t_solve = time.perf_counter() - t0
            solve_launches = dict(bm.LAUNCHES)
            true_rel = hdg_true_rel(torch, m)
            log(f"{tag} SolveInitial(GS=True, tol={MCS2D_TOL:g}, {kname} "
                f"{m.stokes_bpcg_scale_k:.6g}): {res.iterations} BPCG "
                f"iterations (converged {res.converged}), {t_solve:.3f} s "
                f"(stokes_bpcg_time {m.stokes_bpcg_time:.3f} s, "
                f"{1e3 * t_solve / max(res.iterations, 1):.2f} ms per "
                f"iteration); true f64 rel residual {true_rel:.3e}; "
                f"launches {solve_launches}")
            check(res.converged, f"{tag} BPCG did not converge")
            check(true_rel <= 1e-8, f"{tag} true residual {true_rel:.3e}")
            check(solve_launches.get("batched_local_matvec_f64", 0) > 0,
                  f"{tag} kernel 8 never launched in the solve")
            if k is not None:
                ok, err = count_matches(res, n_jax, MCS2D_TOL, MCS2D_PLATEAU)
                log(f"{tag} errors at iterations {n_jax - 2}.. (JAX count "
                    f"{n_jax}): " + ", ".join(f"{e:.3e}" for e in err))
                check(ok, f"{tag} {res.iterations} iterations with the JAX "
                      f"k, JAX {n_jax}")
                jax_launches = solve_launches

        t0 = time.perf_counter()
        m.make_step_fn()
        torch.cuda.synchronize()
        log(f"{tag} step setup {time.perf_counter() - t0:.2f} s: "
            + ", ".join(f"{k} {v:.2f} s" for k, v in m.setup_seconds.items()))
        if maxh == MCS2D_MAXH:
            step = m.make_step_fn()
            u0 = m.u
            u1 = step(u0)
            c1 = dict(m.last_iterations)
            u2 = step(u0)
            torch.cuda.synchronize()
            same = torch.equal(u1, u2)
            log(f"[repeat] MCS 2D f64 step twice from the same state: "
                f"{'bitwise equal' if same else 'DIFFERENT'}, max |d| "
                f"{float((u1 - u2).abs().max()):.3e}, CG counts {c1} / "
                f"{dict(m.last_iterations)}")
            check(same, "[repeat] two 2D MCS steps from the same state "
                  "differ")
            del u1, u2
        _, step_launches = steps_2d(torch, bm, m, MCS2D_STEPS, tag)
        check(step_launches.get("batched_local_matvec_f64", 0) > 0,
              f"{tag} kernel 8 never launched in the steps")
        if maxh == MCS2D_MAXH:
            path_launches = {
                k: jax_launches.get(k, 0) + step_launches.get(k, 0)
                for k in set(jax_launches) | set(step_launches)}
        del m, preA, groups, tables, pre2
    secs = time.perf_counter() - t_phase
    log(f"[mcs2d] phase {secs:.1f} s")
    return secs, path_launches


def th2d_phase(torch, bm, lm, timer, gen, reports):
    """[th2d]: the Taylor-Hood ``NavierStokes`` at the 2D demo's
    configuration: setup seconds; kernel 8 on its f64 viscous and mass
    tables and the velocity two-level patch inverses against its plain
    version; ``SolveInitial(iterative=True, tol=1e-10)`` with the JAX
    package's k (count ``TH2D_JAX``, by :func:`count_matches`) and true f64
    residual; MCS2D_STEPS ``DoTimeStep``s.  Returns (seconds, launches)."""
    from navier_stokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_mesh,
    )
    from navier_stokes_tpu_torch.models import NavierStokes
    from navier_stokes_tpu_torch.scripts.navier_stokes_2d import uin

    t_phase = time.perf_counter()
    tag = f"[th2d] maxh={MCS2D_MAXH}"
    mesh = channel_with_cylinder_mesh(MCS2D_MAXH)
    t0 = time.perf_counter()
    m = NavierStokes(mesh, nu=NU, inflow="inlet", outflow="outlet",
                     wall="wall|cyl", uin=uin, timestep=1e-3, order=ORDER,
                     device="cuda")
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    log(f"{tag}: {mesh.ne} triangles, ndof {m.V.ndof}+{m.Q.ndof}; model "
        f"{t_model:.1f} s (with the two-level preconditioners)")
    rep64 = reports["batched_local_matvec_f64_th2d"]
    tables = [("A_tab", m.A_tab), ("M_loc", m.M_loc)]
    tables += [(f"patch inverses {c}", t) for c, t in
               enumerate(m.preA_tables)]
    for tname, A in tables:
        check_local_mv(torch, lm, timer, rep64, f"th2d {tname}", A, gen)
    bm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = m.SolveInitial(iterative=True, tol=MCS2D_TOL, scale_k=TH2D_JAX[1])
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    solve_launches = dict(bm.LAUNCHES)
    true_rel = th_true_rel(torch, m)
    log(f"{tag} SolveInitial(tol={MCS2D_TOL:g}, JAX k {TH2D_JAX[1]:.6g}): "
        f"{res.iterations} BPCG iterations (converged {res.converged}), "
        f"{t_solve:.3f} s (stokes_bpcg_time {m.stokes_bpcg_time:.3f} s); "
        f"true f64 rel residual {true_rel:.3e}; launches {solve_launches}")
    check(res.converged, f"{tag} BPCG did not converge")
    check(true_rel <= 1e-8, f"{tag} true residual {true_rel:.3e}")
    ok, err = count_matches(res, TH2D_JAX[0], MCS2D_TOL, MCS2D_PLATEAU)
    log(f"{tag} errors at iterations {TH2D_JAX[0] - 2}.. (JAX count "
        f"{TH2D_JAX[0]}): " + ", ".join(f"{e:.3e}" for e in err))
    check(ok, f"{tag} {res.iterations} iterations with the JAX k, JAX "
          f"{TH2D_JAX[0]}")
    check(solve_launches.get("batched_local_matvec_f64", 0) > 0,
          f"{tag} kernel 8 never launched in the solve")
    _, step_launches = steps_2d(torch, bm, m, MCS2D_STEPS, tag)
    check(step_launches.get("batched_local_matvec_f64", 0) > 0,
          f"{tag} kernel 8 never launched in the steps")
    log(f"{tag} setup " + ", ".join(f"{k} {v:.2f} s"
                                    for k, v in m.setup_seconds.items()))
    launches = {k: solve_launches.get(k, 0) + step_launches.get(k, 0)
                for k in set(solve_launches) | set(step_launches)}
    secs = time.perf_counter() - t_phase
    log(f"[th2d] phase {secs:.1f} s")
    return secs, launches


def stokes_true_rel(torch, system, u, p):
    """||r|| / ||(f, g)|| of a StokesSystem's saddle system at (u - u_bc,
    p), through its f64 operators."""
    du = u - system.u_bc
    r0 = system.f - system.A(du) - system.BT(p)
    r1 = system.g - system.B(du)
    return float(torch.sqrt(torch.dot(r0, r0) + torch.dot(r1, r1))
                 / torch.sqrt(torch.dot(system.f, system.f)
                              + torch.dot(system.g, system.g)))


def add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def stokes_solve_check(torch, tag, system, res, u, p, jax, launches):
    """A solve of the Stokes catalog given the JAX k, against the JAX
    figures ``jax`` = (count, k, true residual, errors at iterations 10,
    20, 30 or None): converged; the true residual within STOKES_RES_FACTOR
    of JAX's; the count held to JAX's by :func:`count_matches` -- or,
    where ``jax`` carries the error history's head (the HDG solves, whose
    Bramble-Pasciak form is indefinite at JAX's k, so that the count is
    decided by roundoff), that head within STOKES_HEAD_TOL of JAX's, the
    true residual within STOKES_HDG_RES_FACTOR and the count only printed;
    the inlet velocity equal to its boundary values; kernel 8 launched."""
    import numpy as np

    n_jax, _, res_jax, head = jax
    true_rel = stokes_true_rel(torch, system, u, p)
    ok, err = count_matches(res, n_jax, STOKES_TOL, STOKES_PLATEAU)
    log(f"{tag}: {res.iterations} iterations (JAX {n_jax}; converged "
        f"{res.converged}), true rel residual {true_rel:.4e} (JAX "
        f"{res_jax:.4e}, x{true_rel / res_jax:.3f}); errors at iterations "
        f"{n_jax - 2}..: " + ", ".join(f"{e:.3e}" for e in err)
        + "; launches " + str({k: v for k, v in launches.items() if v}))
    check(res.converged, f"{tag} did not converge")
    if head is None:
        check(ok, f"{tag} {res.iterations} iterations with the JAX k, JAX "
              f"{n_jax}")
        check(true_rel <= STOKES_RES_FACTOR * res_jax,
              f"{tag} true residual {true_rel:.3e}, JAX {res_jax:.3e}")
    else:
        rel = {i: abs(float(res.errors[i]) / e - 1) for i, e in head.items()}
        log(f"{tag}: error history at iterations {list(head)} off JAX's by "
            + ", ".join(f"{r:.2e}" for r in rel.values()) + " (relative)")
        check(max(rel.values()) <= STOKES_HEAD_TOL,
              f"{tag} error history off JAX's: {rel}")
        check(true_rel <= STOKES_HDG_RES_FACTOR * res_jax,
              f"{tag} true residual {true_rel:.3e}, JAX {res_jax:.3e}")
    V = system.V
    if hasattr(V, "scalar"):
        inlet = V.boundary_dof_mask("inlet")
    else:
        inlet = np.concatenate([V.hdiv.boundary_dof_mask("inlet"),
                                V.facet.boundary_dof_mask("inlet")])
    inlet = torch.as_tensor(inlet, device=u.device)
    check(bool(inlet.any()) and torch.equal(u[inlet], system.u_bc[inlet]),
          f"{tag} the inlet velocity differs from its boundary values")
    check(launches.get("batched_local_matvec_f64", 0) > 0,
          f"{tag} kernel 8 never launched")
    return true_rel


def stokes_phase(torch, bm, lm, timer, gen, reports, here):
    """[stokes]: the Stokes catalog on the card at the reference's sizes.

    1. the active configuration of scripts/run_stokes.py ("HDG BDM 2",
       alpha 10, edgeblock, order-3 curved cylinder, BPCG to 1e-7) through
       the port's ``run`` harness as the script calls it, at maxh 0.1,
       with the JAX k, its CSV written under build/stokes/; then the
       port's own k;
    2. the same system at maxh 0.01 (setup seconds, JAX's k);
    3. the mixed pairs at maxh 0.1 (Jacobi, BPCG to 1e-7 with JAX's k)
       and Taylor-Hood 2 with block-preconditioned MINRES;
    4. the MCS triple as scripts/stokes_hcurldiv.py runs it (maxh 0.06):
       the direct solve on the host, MINRES to 1e-8 on the card;
    5. kernel 8 against its plain version on each new table.
    Each solve is held to JAX's figures by :func:`stokes_solve_check`.
    The launch counters are set to 0 just before each solve and read just
    after.  Returns (seconds, launches summed over the solves)."""
    import csv as csv_mod

    import numpy as np

    from navier_stokes_tpu_torch.mesh.curved import curve_to_circle
    from navier_stokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_mesh,
    )
    from navier_stokes_tpu_torch.models import discretizations as disc
    from navier_stokes_tpu_torch.models import stokes as st
    from navier_stokes_tpu_torch.models.stokes_hybrid import (
        build_hybrid_stokes_system,
    )
    from navier_stokes_tpu_torch.models.stokes_mcs import (
        assemble_mcs_stokes,
        mcs_discretization,
        solve_mcs_direct,
        solve_mcs_minres,
    )
    from navier_stokes_tpu_torch.scripts import run_stokes

    t_phase = time.perf_counter()
    rep = reports["batched_local_matvec_f64_stokes"]
    total = {}

    # 1. run_stokes.py's active configuration through the harness
    jax = STOKES_HDG_JAX[STOKES_MAXH]
    k_jax = jax[1]
    got = {}

    def bpcg_jax_k(system):
        got["system"] = system
        return st.solve_with_bramble_pasciak_cg(
            system, tolerance=STOKES_TOL, max_steps=STOKES_MAXSTEPS,
            scale_k=k_jax, result=got)

    out_dir = os.path.join(here, "build", "stokes")
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "errors.csv")
    bm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = st.run(run_stokes.mesh_sizes, run_stokes.methods("cuda"),
                  {"bramble pasciak cg": bpcg_jax_k}, csv_path)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = dict(bm.LAUNCHES)
    add_launches(total, launches)
    system, res = got["system"], got["result"]
    u, p = system.lift(res.x[0]), res.x[1]
    tag = f"[stokes] HDG BDM 2 maxh={STOKES_MAXH} (run_stokes.py, run())"
    log(f"{tag}: ndof {system.V.ndof}+{system.Q.ndof}, harness {t_run:.2f} s"
        f" (setup and solve), BPCG {rows[-1]['solver_time']:.3f} s")
    check(run_stokes.mesh_sizes == [STOKES_MAXH]
          and system.V.ndof == 5112 and system.Q.ndof == 1230,
          f"{tag}: unexpected size {system.V.ndof}+{system.Q.ndof}")
    stokes_solve_check(torch, tag, system, res, u, p, jax, launches)
    with open(csv_path, newline="") as fh:
        table = list(csv_mod.reader(fh))
    check(table[0] == [""] + list(st.CSV_COLUMNS)
          and len(table) == len(rows) + 1 == res.iterations + 2
          and table[1][2] == "HDG BDM 2" and table[-1][-1] == "hybrid_dg",
          f"{tag}: the CSV does not hold the run's rows")
    log(f"{tag}: wrote {len(rows)} rows to {os.path.relpath(csv_path, here)}")
    for tname, A in system.tables.items():
        check_local_mv(torch, lm, timer, rep, f"stokes hdg {STOKES_MAXH} "
                       f"{tname}", A, gen)
    own = {}
    bm.reset_launches()
    st.solve_with_bramble_pasciak_cg(system, tolerance=STOKES_TOL,
                                     max_steps=STOKES_MAXSTEPS, result=own)
    torch.cuda.synchronize()
    add_launches(total, bm.LAUNCHES)
    log(f"{tag} with the port's own k {own['scale_k']:.6g} (JAX "
        f"{k_jax:.6g}): {own['result'].iterations} iterations (JAX k: "
        f"{res.iterations}; converged {own['result'].converged})")
    check(own["result"].converged, f"{tag} with its own k did not converge")
    del system, got, own

    # 2. the same at maxh 0.01
    jax = STOKES_HDG_JAX[STOKES_FINE]
    k_jax = jax[1]
    tag = f"[stokes] HDG BDM 2 maxh={STOKES_FINE}"
    t0 = time.perf_counter()
    mesh = channel_with_cylinder_mesh(STOKES_FINE)
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    geo = curve_to_circle(mesh, "cyl", (0.2, 0.2), 0.05, 3)
    system = build_hybrid_stokes_system(
        mesh, disc.bdm_hybrid(2, 10)[0], uin=st.default_inlet_profile(),
        geometry=geo, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    log(f"{tag}: {mesh.ne} triangles, ndof {system.V.ndof}+{system.Q.ndof}; "
        f"mesh {t_mesh:.1f} s, setup (curve, assembly, edgeblock inverses) "
        f"{t_setup:.1f} s; A_loc "
        f"{system.tables['A_loc'].numel() * 8 / 1e6:.1f} MB")
    check(mesh.ne == 17002 and system.V.ndof == 205740
          and system.Q.ndof == 51006, f"{tag}: unexpected size")
    for tname, A in system.tables.items():
        check_local_mv(torch, lm, timer, rep, f"stokes hdg {STOKES_FINE} "
                       f"{tname}", A, gen)
    got = {}
    bm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st.solve_with_bramble_pasciak_cg(system, tolerance=STOKES_TOL,
                                     max_steps=STOKES_MAXSTEPS, scale_k=k_jax,
                                     result=got)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = dict(bm.LAUNCHES)
    add_launches(total, launches)
    res = got["result"]
    log(f"{tag}: BPCG {t_solve:.3f} s "
        f"({1e3 * t_solve / max(res.iterations, 1):.3f} ms per iteration)")
    stokes_solve_check(torch, tag, system, res, system.lift(res.x[0]),
                       res.x[1], jax, launches)
    del system, got, res, mesh, geo

    # 3. the mixed family at maxh 0.1 (Jacobi A-preconditioner)
    mesh = channel_with_cylinder_mesh(STOKES_MAXH)
    catalog = {
        "taylor hood 2": disc.taylor_hood(2),
        "taylor hood 3": disc.taylor_hood(3),
        "mini": disc.mini(),
        "P2, P0": disc.P2_velocity_constant_pressure(),
        "P1nc, P0": disc.P1_nonconforming_velocity_constant_pressure(),
        "P2+, P1": disc.P2_velocity_with_cubic_bubbles_linear_pressure(),
    }
    for name, jax in STOKES_MIXED_JAX.items():
        tag = f"[stokes] mixed {name} maxh={STOKES_MAXH}"
        system = st.build_stokes_system(mesh, catalog[name][0],
                                        uin=st.default_inlet_profile(),
                                        device="cuda")
        check_local_mv(torch, lm, timer, rep, f"stokes {name} K_loc",
                       system.tables["K_loc"], gen)
        got = {}
        bm.reset_launches()
        u, p, _, secs, _ = st.solve_with_bramble_pasciak_cg(
            system, tolerance=STOKES_TOL, max_steps=STOKES_MAXSTEPS,
            scale_k=jax[1], result=got)
        launches = dict(bm.LAUNCHES)
        add_launches(total, launches)
        log(f"{tag}: ndof {system.V.ndof}+{system.Q.ndof}, BPCG {secs:.3f} s")
        stokes_solve_check(torch, tag, system, got["result"], u, p, jax,
                           launches)
        if name == "taylor hood 2":
            got = {}
            bm.reset_launches()
            u, p, _, secs, _ = st.solve_with_min_res(
                system, tolerance=STOKES_TOL, max_steps=STOKES_MAXSTEPS,
                result=got)
            launches = dict(bm.LAUNCHES)
            add_launches(total, launches)
            log(f"{tag} MINRES: {secs:.3f} s")
            stokes_solve_check(torch, f"{tag} MINRES", system, got["result"],
                               u, p, STOKES_MINRES_JAX, launches)

    # 4. MCS as scripts/stokes_hcurldiv.py runs it
    tag = f"[stokes] MCS RT 2 maxh={MCS_MAXH} (stokes_hcurldiv.py)"
    mesh = channel_with_cylinder_mesh(MCS_MAXH)
    V, S, Q = mcs_discretization(2)[0](
        mesh, velocity_dirichlet="wall|inlet|cyl", velocity_neumann="outlet")
    t0 = time.perf_counter()
    system = assemble_mcs_stokes(mesh, V, S, Q, st.default_volume_force,
                                 st.default_inlet_profile())
    t_asm = time.perf_counter() - t0
    x, t_direct = solve_mcs_direct(system)
    A_mcs = torch.as_tensor(system.A_loc, device="cuda")
    check_local_mv(torch, lm, timer, rep, "stokes mcs A_loc", A_mcs, gen)
    del A_mcs
    bm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x2, res = solve_mcs_minres(system, tol=1e-8, maxsteps=MCS_MAXSTEPS,
                               device="cuda")
    t_minres = time.perf_counter() - t0
    launches = dict(bm.LAUNCHES)
    add_launches(total, launches)
    final = float(res.errors[res.iterations])
    diff = float(np.abs(x - x2).max())
    log(f"{tag}: {mesh.ne} triangles, ndofs V={V.ndof} S={S.ndof} "
        f"Q={Q.ndof}; assembly {t_asm:.2f} s, direct solve {t_direct:.3f} s; "
        f"MINRES {res.iterations} iterations (converged {res.converged}; JAX "
        f"{MCS_JAX['iterations']}, not converged) in {t_minres:.2f} s "
        f"({1e3 * t_minres / res.iterations:.4f} ms per iteration), final "
        f"relative error {final:.4e} (JAX {MCS_JAX['final_error']:.4e}), "
        f"agree to {diff:.4e} (JAX {MCS_JAX['max_diff_direct']:.4e}); "
        f"launches {dict((k, v) for k, v in launches.items() if v)}")
    check(res.iterations == MCS_JAX["iterations"] and not res.converged,
          f"{tag}: {res.iterations} MINRES iterations, JAX "
          f"{MCS_JAX['iterations']} (not converged)")
    check(abs(final / MCS_JAX["final_error"] - 1) <= MCS_BAND
          and abs(diff / MCS_JAX["max_diff_direct"] - 1) <= MCS_BAND,
          f"{tag}: final error {final:.3e} or difference {diff:.3e} off "
          "JAX's by more than the band")
    check(launches.get("batched_local_matvec_f64", 0) > 0,
          f"{tag} kernel 8 never launched")
    secs = time.perf_counter() - t_phase
    log(f"[stokes] phase {secs:.1f} s")
    return secs, total


def heat_phase(torch, bm, lm, timer, gen, reports, n_steps=HEAT_RUN):
    """[heat]: ``HeatEquation`` at the reference's literals (maxh 0.1,
    order 10: 200 triangles, 10,201 dofs, 66 x 66 element tables; 10 Gauss
    stages, subspace 5, inner CG to 1e-13): kernel 8 on the mass and
    stiffness tables against its plain version; the first ``n_steps`` time
    steps of the convergence study (3: 8 large steps; 5: 74), each L2
    error held to the JAX package's within HEAT_TOL of the solution's norm;
    the CG count of every solve (each below its 4,000 cap) and the wall
    seconds per step.  The launch counters are set to 0 just before each
    solve and read just after.  Returns (seconds, launches summed over the
    solves)."""
    from navier_stokes_tpu_torch.models.heat import (
        DEFAULT_KL,
        HeatEquation,
        exact_solution,
        sum_of_unit_square_laplace_eigenfunctions,
    )

    t_phase = time.perf_counter()
    rep = reports["batched_local_matvec_f64_heat"]
    t0 = time.perf_counter()
    m = HeatEquation(maxh=0.1, order=10, device="cuda")
    torch.cuda.synchronize()
    log(f"[heat] maxh 0.1, order 10: {m.mesh.ne} triangles, {m.ndof} dofs, "
        f"tables {tuple(m.mass_local.shape)}; setup "
        f"{time.perf_counter() - t0:.2f} s")
    check(m.mesh.ne == 200 and m.ndof == 10201,
          f"[heat] unexpected size {m.mesh.ne}, {m.ndof}")
    for tname, A in (("mass_local", m.mass_local),
                     ("stiff_local", m.stiff_local)):
        check_local_mv(torch, lm, timer, rep, f"heat {tname}", A, gen)
    initial = sum_of_unit_square_laplace_eigenfunctions(DEFAULT_KL)
    total = {}
    for dt, e_jax in list(zip(HEAT_STEPS, HEAT_JAX))[:n_steps]:
        bm.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T, final_time = m.solve(initial, 0.05, dt)
        secs = time.perf_counter() - t0
        launches = dict(bm.LAUNCHES)
        add_launches(total, launches)
        exact = exact_solution(DEFAULT_KL, final_time)
        err = m.l2_error(T, exact)
        norm = m.l2_error(torch.zeros_like(T), exact)
        cg = m.cg_iterations
        n = len(m.step_seconds)
        rel = abs(err - e_jax) / e_jax
        log(f"[heat] dt={dt:.6g}: {n} steps in {secs:.3f} s "
            f"({secs / n:.3f} s per step, "
            f"{1e3 * secs / sum(cg):.4f} ms per CG iteration), L2 error "
            f"{err:.10e} (JAX {e_jax:.10e}: {rel:.2e} of the error, "
            f"{abs(err - e_jax) / norm:.2e} of the state's norm); CG per "
            f"solve {min(cg)}-{max(cg)}, mean {sum(cg) / len(cg):.1f}, "
            f"{sum(cg)} in all; launches per step "
            f"{dict((k, v / n) for k, v in launches.items() if v)}")
        check(bool(torch.isfinite(T).all()), f"[heat] dt={dt}: non-finite")
        check(max(cg) < m.inner_maxsteps,
              f"[heat] dt={dt}: a CG solve reached {max(cg)} iterations")
        check(abs(err - e_jax) <= HEAT_TOL * norm,
              f"[heat] dt={dt}: L2 error {err:.6e}, JAX {e_jax:.6e}, "
              f"{abs(err - e_jax) / norm:.2e} of the state's norm")
        check(launches.get("batched_local_matvec_f64", 0) > 0,
              f"[heat] dt={dt}: kernel 8 never launched")
    secs = time.perf_counter() - t_phase
    log(f"[heat] phase {secs:.1f} s")
    return secs, total


def sweep_log(tag, log_, nus):
    """One line per member of a ``run_reynolds_ensemble_mcs`` log: nu, the
    M* and projection CG counts of each step, seconds per step."""
    for i, nu in enumerate(nus):
        rows = [r for r in log_ if r["member"] == i]
        log(f"{tag} member {i} nu={nu:.6g}: M* CG "
            f"{[r['mstar'] for r in rows]}, projection CG "
            f"{[r['project'] for r in rows]}, "
            + ", ".join(f"{r['seconds']:.3f}" for r in rows)
            + " s per step")


def sweep_against_jax(tag, out, log_, jax, u_bc, members):
    """Each row of ``out`` (the members ``members``; row 0 member 0) held to
    the JAX numbers ``jax`` (one dict per row): one log line per member and
    the worst relative max |u|, ||u_i - u_0||, ||u_i - u_bc|| and, where
    ``log_`` holds the CG counts, their largest distance."""
    import torch

    worst = dict.fromkeys(("max_abs_u", "dist_u0", "dist_u_bc", "count"),
                          0)
    for row, (i, jax_i) in enumerate(zip(members, jax)):
        got = {"max_abs_u": float(out[row].abs().max()),
               "dist_u0": float(torch.linalg.norm(out[row] - out[0])),
               "dist_u_bc": float(torch.linalg.norm(out[row] - u_bc))}
        for k, v in got.items():
            if jax_i[k]:
                worst[k] = max(worst[k], abs(v - jax_i[k]) / jax_i[k])
        line = (f"{tag} member {i}: max |u| {got['max_abs_u']:.12f} (JAX "
                f"{jax_i['max_abs_u']:.12f}), ||u_i - u_0|| "
                f"{got['dist_u0']:.10e} (JAX {jax_i['dist_u0']:.10e}), "
                f"||u_i - u_bc|| {got['dist_u_bc']:.10e} (JAX "
                f"{jax_i['dist_u_bc']:.10e})")
        if log_ is not None:
            rows = [r for r in log_ if r["member"] == i]
            counts = [r[k] for r in rows for k in ("mstar", "project")]
            jcounts = [c for pair in zip(jax_i["mstar"], jax_i["project"])
                       for c in pair]
            worst["count"] = max(worst["count"], max(
                abs(a - b) for a, b in zip(counts, jcounts)))
            line += f"; CG {counts} (JAX {jcounts})"
        log(line)
    return worst


def sweep_small(torch, sweep, build_model, nus):
    """[sweep]'s ensemble on the straight channel at SWEEP_SMALL_MAXH, the
    JAX host's element-interior functions carried in, held to the JAX
    package's numbers at the step's own M* CG stop and at SWEEP_TIGHT_CG;
    the float32 control must break the tight bound."""
    tag = f"[sweep] maxh={SWEEP_SMALL_MAXH}"
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    with carried_cell_bases(os.path.join(here, SWEEP_SMALL_BASES)) as cb:
        ms = build_model(SWEEP_SMALL_MAXH, curved=False, device="cuda")
    log(f"{tag}: model built in {time.perf_counter() - t0:.1f} s, the "
        f"JAX host's element-interior BDM_2 functions carried "
        f"into {cb.combos} combos: off the port's own null space by "
        f"{cb.off_span:.2e}, apart from the port's own functions by "
        f"{cb.apart:.2e}")
    check(cb.combos > 0 and cb.off_span <= 1e-12,
          f"{tag} the carried functions leave the port's null space "
          f"({cb.off_span:.2e})")
    ms.load_state(cheb_bounds=SWEEP_SMALL_JAX["cheb_bounds"])
    check(ms.n == SWEEP_SMALL_JAX["ndof"], f"{tag} {ms.n} dofs, JAX "
          f"{SWEEP_SMALL_JAX['ndof']}")
    runs = {}
    for tol, jax, bounds in ((1e-4, SWEEP_SMALL_JAX["members"],
                              SWEEP_SMALL_TOL),
                             (SWEEP_TIGHT_CG, SWEEP_TIGHT_JAX,
                              SWEEP_TIGHT_TOL)):
        jax = jax[::SWEEP_EVERY]  # the JAX rows of the members run
        log_ = []
        t1 = time.perf_counter()
        out = sweep.run_reynolds_ensemble_mcs(ms, nus, SWEEP_STEPS,
                                              log=log_, mstar_tol=tol)
        torch.cuda.synchronize()
        log(f"{tag} M* CG to {tol:g}: {ms.mesh.ne} tets, {ms.n} dofs; "
            f"ensemble {time.perf_counter() - t1:.1f} s")
        sweep_log(f"{tag} M* {tol:g}", log_, nus)
        worst = sweep_against_jax(f"{tag} M* {tol:g}", out, log_, jax,
                                  ms.u_bc, range(len(nus)))
        log(f"{tag} M* CG to {tol:g} against JAX: worst relative max |u| "
            f"{worst['max_abs_u']:.2e}, ||u_i - u_0|| "
            f"{worst['dist_u0']:.2e}, ||u_i - u_bc|| "
            f"{worst['dist_u_bc']:.2e}; CG counts at most "
            f"{worst['count']} apart (bounds {bounds})")
        for k, bound in bounds.items():
            check(worst[k] <= bound,
                  f"{tag} M* {tol:g}: {k} {worst[k]:.3e} over {bound}")
        runs[tol] = out
    # the control: the step's nu-split and mass applies in float32 (the
    # route of elem_apply_multi before its repair) must break the bound
    from navier_stokes_tpu_torch.ops.faceblock import FaceBlockLayout

    own = FaceBlockLayout.elem_apply_multi

    def f32_multi(self, mats_and_scales):
        apply = own(self, [(torch.as_tensor(A).float(), c)
                           for A, c in mats_and_scales])
        return lambda u: apply(u.float()).double()

    i = SWEEP_CONTROL
    FaceBlockLayout.elem_apply_multi = f32_multi
    try:
        step = sweep.make_viscosity_step_mcs(ms, SWEEP_TIGHT_CG)
        ctl = sweep.advance_ensemble(ms, step, nus[i:i + 1], SWEEP_STEPS)
    finally:
        FaceBlockLayout.elem_apply_multi = own
    rows = torch.cat([runs[SWEEP_TIGHT_CG][:1], ctl])
    worst = sweep_against_jax(f"{tag} control", rows, None,
                              [SWEEP_TIGHT_JAX[0],
                               SWEEP_TIGHT_JAX[SWEEP_EVERY * i]],
                              ms.u_bc, (0, i))
    off = max(worst[k] for k in ("max_abs_u", "dist_u0", "dist_u_bc"))
    log(f"{tag} control (member {i}, the applies in float32, M* CG to "
        f"{SWEEP_TIGHT_CG:g}): {off:.2e} from JAX, bound "
        f"{SWEEP_TIGHT_TOL['max_abs_u']:g}")
    check(off > SWEEP_TIGHT_TOL["max_abs_u"],
          f"{tag} the float32 control stays within the bound ({off:.2e})")


def sweep_phase(torch, bm, lm, timer, gen, reports, m, u_start):
    """[sweep]: the Reynolds-number ensemble of ``parallel/sweep.py`` on the
    curved f64 model ``m`` (maxh 0.09) from ``u_start``: kernel 8 on the
    step's nu-split tables G1, G2, G3 and the mass M against its plain
    version; ``run_reynolds_ensemble_mcs`` with SWEEP_MEMBERS viscosities
    and SWEEP_STEPS steps, the launch counters set to 0 just before it and
    read just after (kernel 8 in f64 must launch); every state finite, the
    first and last members apart; the first and last members run alone
    ``torch.equal`` to their rows; the member at the model's nu against
    ``DoTimeStep``; the C++ meshkit kernels loaded.  Then the same ensemble
    on the straight channel at SWEEP_SMALL_MAXH, built with the JAX host's
    element-interior functions, held to the JAX package's numbers at the
    step's own M* CG stop and with the M* CG to SWEEP_TIGHT_CG, where a
    float32 control must break the bound.  ``m``'s state is put back.  Returns (seconds, launches of the
    maxh 0.09 ensemble)."""
    import numpy as np

    from navier_stokes_tpu_torch.flagship import build_model
    from navier_stokes_tpu_torch.parallel import sweep
    from navier_stokes_tpu_torch.utils import native

    t_phase = time.perf_counter()
    tag = f"[sweep] maxh={MAXH}"
    check(native.available(), "[sweep] the C++ meshkit kernels did not load")
    nus = np.geomspace(1e-3, 1e-2, SWEEP_MEMBERS)[::SWEEP_EVERY]
    n_mem = len(nus)
    u_keep = m.u
    m.u = u_start
    t0 = time.perf_counter()
    step = sweep.make_viscosity_step_mcs(m)
    torch.cuda.synchronize()
    log(f"{tag}: step setup {time.perf_counter() - t0:.1f} s (the nu-split "
        f"tables in f64 numpy on the host, face-major, shipped); tables "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in step.tables.items()))
    for tname, A in step.tables.items():
        check_local_mv(torch, lm, timer,
                       reports["batched_local_matvec_f64_sweep"],
                       f"sweep {tname}", A, gen)

    log_ = []
    bm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sweep.run_reynolds_ensemble_mcs(m, nus, SWEEP_STEPS, log=log_)
    torch.cuda.synchronize()
    t_ens = time.perf_counter() - t0
    launches = dict(bm.LAUNCHES)
    n_steps = n_mem * SWEEP_STEPS
    step_secs = sum(r["seconds"] for r in log_)
    per_step = launches.get("batched_local_matvec_f64", 0) / n_steps
    log(f"{tag} run_reynolds_ensemble_mcs: {n_mem} members x "
        f"{SWEEP_STEPS} steps in {t_ens:.3f} s (setup {t_ens - step_secs:.1f}"
        f" s, {step_secs / n_steps:.3f} s per member step); launches "
        f"{launches} ({per_step:.1f} kernel-8 launches per member step)")
    sweep_log(tag, log_, nus)
    check(tuple(out.shape) == (n_mem, m.n) and out.is_cuda,
          f"{tag} ensemble of shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), f"{tag} non-finite states")
    check(launches.get("batched_local_matvec_f64", 0) > 0,
          f"{tag} kernel 8 never launched in the ensemble")
    apart = float((out[0] - out[-1]).abs().max())
    log(f"{tag} max |u_0 - u_{n_mem - 1}| = {apart:.3e}; max |u| "
        + ", ".join(f"{float(r.abs().max()):.6f}" for r in out))
    check(apart > 1e-8, f"{tag} the first and last members agree")
    for i in (0, n_mem - 1):
        alone = sweep.advance_ensemble(m, step, nus[i:i + 1], SWEEP_STEPS)
        same = torch.equal(alone[0], out[i])
        log(f"{tag} member {i} run alone: "
            f"{'bitwise equal' if same else 'DIFFERENT'} to its row")
        check(same, f"{tag} member {i} alone differs from its row")
    u1 = step(u_start, m.nu)
    m.DoTimeStep()
    dts = float((u1 - m.u).abs().max() / m.u.abs().max())
    log(f"{tag} one step at the model's nu against DoTimeStep: "
        f"{dts:.3e} of max |u| (bound {SWEEP_DTS_TOL:g})")
    m.u = u_keep
    check(dts <= SWEEP_DTS_TOL, f"{tag} DoTimeStep differs by {dts:.3e}")
    del step, out, alone, u1

    sweep_small(torch, sweep, build_model, nus)
    secs = time.perf_counter() - t_phase
    log(f"[sweep] phase {secs:.1f} s")
    return secs, launches


def ns_sweep_phase(torch, bm, here):
    """[ns-sweep]: the port's ``scripts/run_ns_sweep.py`` default subset
    through its ``main`` (12 initial Stokes solves of the 2D MCS model with
    its own Bramble-Pasciak k, the CSV under build/ns_sweep/), the launch
    counters set to 0 just before it and read just after (kernel 8 in f64
    must launch); then each configuration again through ``solve`` with the
    JAX package's k, its count held to JAX's by :func:`count_matches`.
    Returns (seconds, launches of ``main``)."""
    from navier_stokes_tpu_torch.scripts import run_ns_sweep as ns

    t_phase = time.perf_counter()
    out_dir = os.path.join(here, "build", "ns_sweep")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "data.csv")
    bm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = ns.main(["--out", path])
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = dict(bm.LAUNCHES)
    with open(path) as fh:
        lines = fh.read().splitlines()
    log(f"[ns-sweep] run_ns_sweep.main: {len(rows)} solves in {t_main:.1f} s"
        f" (CSV of {len(lines)} lines, header {lines[0]!r}); launches "
        f"{launches}")
    check(len(rows) == len(NS_SWEEP_JAX) and len(lines) == len(rows) + 1,
          f"[ns-sweep] {len(rows)} rows, {len(lines)} CSV lines")
    check(lines[0] == ",mesh_size,order,iterations,time,"
          "gauss_seidel_enabled", f"[ns-sweep] CSV header {lines[0]!r}")
    check(launches.get("batched_local_matvec_f64", 0) > 0,
          "[ns-sweep] kernel 8 never launched")
    cache = {}
    for row in rows:
        key = (row["mesh_size"], row["order"], row["gauss_seidel_enabled"])
        n_jax, k_jax = NS_SWEEP_JAX[key]
        res = []
        n, secs = ns.solve(*key, cache, True, device="cuda", scale_k=k_jax,
                           result=res)
        ok, err = count_matches(res[0], n_jax, NS_SWEEP_TOL, MCS2D_PLATEAU)
        log(f"[ns-sweep] h={key[0]} p={key[1]} GS={key[2]}: {n} with the "
            f"JAX k {k_jax:.6g} (JAX {n_jax}), {secs:.3f} s; own k "
            f"{row['iterations']} in {row['time']:.3f} s; errors at "
            f"{n_jax - 2}..: " + ", ".join(f"{e:.3e}" for e in err))
        check(bool(res[0].converged), f"[ns-sweep] {key} did not converge")
        check(ok, f"[ns-sweep] {key}: {n} iterations with the JAX k, JAX "
              f"{n_jax}")
    secs = time.perf_counter() - t_phase
    log(f"[ns-sweep] phase {secs:.1f} s")
    return secs, launches


def shard_true_rel(torch, m, u, p):
    """The true relative residual of the 3D MCS model's initial Stokes
    system at the correction (u, p), through its plain f64 operators."""
    f = torch.where(m.free, m.f - m.A_raw(m.u_bc), 0.0)
    g = -m.B_raw(m.u_bc)
    r0 = f - m.A(u) - m.BT(p)
    r1 = g - m.B(u)
    return float(torch.sqrt(torch.dot(r0, r0) + torch.dot(r1, r1))
                 / torch.sqrt(torch.dot(f, f) + torch.dot(g, g)))


def shard_match(n, n_jax):
    """The JAX package's rule for a sharded count (tests/test_faceshard.py)."""
    return abs(n - n_jax) <= max(10, 0.1 * n_jax)


def shard_stats(tag, plan, inner, stats):
    """Print the setup and solve seconds, the halo against the owned face
    rows and the collective calls per inner iteration of a sharded solve."""
    halo = [len(h) for h in plan.halo_faces]
    own = [len(o) for o in plan.own_faces]
    per = {k: v / max(inner, 1) for k, v in stats["collectives"].items()}
    host = stats.get("host_seconds", {})
    log(f"{tag}: host setup {host.get('all', 0.0):.1f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in host.items() if k != "all")
        + f"), rank setup {stats['setup_seconds']:.1f} s, solve "
        f"{stats['solve_seconds']:.3f} s; halo face rows {halo} against "
        f"owned {own} ({sum(halo) / max(sum(own), 1):.1%}); collective "
        f"calls per inner iteration "
        + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
        + f"; launches {stats['launches']}")
    return per


def shard_phase(torch, bm, lm, timer, gen, reports, m):
    """[shard]: the sharded solves of ``parallel/`` on torch.distributed.

    World size 1 (NCCL, this process, an in-memory store): the main path's
    model ``m`` sharded with bench.py's table settings, kernels 1, 2 and 8
    held to their plain versions on the shard's tables (every table of the
    operators and the preconditioner but the GS colors past the first,
    which are checked untimed), then ``sharded_fast_flagship_solve`` with
    bench.py's inner settings, the launch counters set to 0 just before it
    and read just after (kernels 1, 2 and 8 must launch): a true f64
    residual <= TOL, the inner count within the JAX rule of 358.  World
    size 2 (two gloo ranks on the one card): the dd solve on the 2D
    vertexstar model at SHARD_DD_MAXH, held to the JAX package's count,
    its velocity within SHARD_DD_DIFF of the single-device SolveInitial
    (the face-sharded solve on two ranks is :func:`shard_face_phase`, in a
    process of its own).  A failed rank fails the phase.  Returns
    (seconds, launches of the world size 1 solve)."""
    import torch.distributed as dist

    from navier_stokes_tpu_torch.mesh import channel_with_cylinder_mesh
    from navier_stokes_tpu_torch.models import NavierStokesMCS
    from navier_stokes_tpu_torch.parallel import ddshard, faceshard
    from navier_stokes_tpu_torch.parallel.sharding import (
        Ranks,
        single_rank,
    )
    from navier_stokes_tpu_torch.scripts.navier_stokes_2d import uin as uin2

    t_phase = time.perf_counter()
    tag = f"[shard] world size 1, maxh={MAXH}"
    bf16 = torch.bfloat16
    mesh = single_rank("nccl")
    try:
        t0 = time.perf_counter()
        ops = faceshard.build_sharded_fast_ops(
            m, mesh, gs=True, ext_dtype=bf16, inv_dtype=bf16,
            **SHARD_BENCH_TABLES)
        torch.cuda.synchronize()
        ops32, ops64, D, plan, aux = ops
        log(f"{tag}: build_sharded_fast_ops {time.perf_counter() - t0:.1f} s"
            f" (host " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                   aux["host_seconds"].items())
            + f"; rank {aux['seconds']:.1f} s); {len(aux['tables'])} "
            f"device tables; coarse theta {aux['coarse_theta']:.4f}")
        tabs = aux["tables"]
        log(f"[kernels] {tag}: block_mv, block_mv2, batched_local_matvec "
            "on the shard's tables")
        for tname, A in tabs.items():
            if tname in ("A_hi", "A_lo", "B_hi", "B_lo", "BT_hi", "BT_lo",
                         "A_64"):
                continue
            seg = isinstance(A, bm.SegmentTable)
            if tname.startswith("GS color") and not tname.startswith(
                    "GS color 0 "):  # the other colors: checked, not timed
                P = A.padded() if seg else A
                x = torch.randn((P.shape[0], P.shape[2]), generator=gen,
                                device="cuda")
                y, y_ref = ((bm.block_mv_segments(A, x),
                             bm.block_mv_segments_plain(A, x)) if seg else
                            (bm.block_mv(A, x), bm.block_mv_plain(A, x)))
                scale = torch.einsum("bmk,bk->bm", P.double().abs(),
                                     x.double().abs())
                worst = float(((y - y_ref).abs().double()
                               / scale.clamp_min(1e-300)).max())
                check(worst <= 1e-5, f"{tag} block_mv {tname}: {worst:.2e}")
                continue
            if seg:
                check_block_mv_segments(torch, bm, timer,
                                        reports["block_mv_shard"],
                                        f"shard {tname}", A, gen)
            else:
                check_block_mv(torch, bm, timer, reports["block_mv_shard"],
                               f"shard {tname}", A, gen)
        for hi, lo in (("A_hi", "A_lo"), ("B_hi", "B_lo"),
                       ("BT_hi", "BT_lo")):
            check_block_mv2(torch, bm, timer, reports["block_mv2_shard"],
                            f"shard {hi[:-3]}", tabs[hi], tabs[lo], gen)
        check_local_mv(torch, lm, timer,
                       reports["batched_local_matvec_f64_shard"],
                       "shard A_64", tabs["A_64"], gen)

        bm.reset_launches()
        torch.cuda.synchronize()
        (xu, xp), rel, passes, inner, plan = \
            faceshard.sharded_fast_flagship_solve(
                m, mesh, tol=TOL, ops=ops, **SHARD_INNER)
        torch.cuda.synchronize()
        launches = dict(bm.LAUNCHES)
        stats = plan.run_stats
        stats["host_seconds"] = aux["host_seconds"]
        true = shard_true_rel(torch, m, torch.as_tensor(xu, device="cuda"),
                              torch.as_tensor(xp, device="cuda"))
        log(f"{tag} sharded_fast_flagship_solve: inner {inner}, passes "
            f"{passes}, driver rel {rel:.3e}, true f64 rel {true:.3e} "
            f"(single-device flagship: {SHARD_MAIN_INNER} inner)")
        per = shard_stats(tag, plan, inner, stats)
        # what one collective costs here: the calls of an inner iteration
        # against the iteration's wall time
        row = torch.randn((64, m.fb.nfb), generator=gen, device="cuda")
        one = torch.ones((), device="cuda", dtype=torch.float64)
        cost = {}
        for name, call in (("all_gather", lambda: mesh.all_gather(row)),
                           ("all_reduce", lambda: mesh.all_reduce(one))):
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                call()
            torch.cuda.synchronize()
            cost[name] = (time.perf_counter() - t0) / 200
        it_s = stats["solve_seconds"] / max(inner, 1)
        share = sum(per[k] * cost[k] for k in cost) / it_s
        log(f"{tag}: one collective call costs "
            + ", ".join(f"{k} {v * 1e6:.1f} us" for k, v in cost.items())
            + f" (NCCL, one rank); an inner iteration {it_s * 1e3:.2f} ms, "
            f"of which the collectives' calls at that cost {share:.1%}")
        check(true <= TOL and math.isfinite(true),
              f"{tag}: true residual {true:.3e}")
        check(shard_match(inner, SHARD_MAIN_INNER),
              f"{tag}: {inner} inner iterations, single device "
              f"{SHARD_MAIN_INNER}")
        for name in ("block_mv", "block_mv2", "batched_local_matvec_f64"):
            check(launches.get(name, 0) > 0,
                  f"{tag}: {name} never launched")
        del ops, ops32, ops64, D, aux, tabs
    finally:
        dist.destroy_process_group()

    # world size 2: gloo, both ranks on cuda:0
    ranks = Ranks(SHARD_RANKS, backend="gloo", device="cuda:0", threads=2)
    tag = (f"[shard] world size {SHARD_RANKS} (gloo), dd, 2D "
           f"maxh={SHARD_DD_MAXH}")
    jd = SHARD_JAX["dd"]
    kw = dict(nu=NU, inflow="inlet", outflow="outlet", wall="wall|cyl",
              uin=uin2, timestep=1e-3, order=ORDER,
              preconditioner="vertexstar", device="cuda")
    ns2 = NavierStokesMCS(channel_with_cylinder_mesh(SHARD_DD_MAXH), **kw)
    bundles, pu, _ = ddshard.dd_flagship_tables(ns2, SHARD_RANKS)
    t0 = time.perf_counter()
    res, dd_launches = ranks.run(ddshard.dd_solve_rank, jd["tol"], 3000,
                                 jd["scale_k"], rank_args=bundles)
    t_call = time.perf_counter() - t0
    single = NavierStokesMCS(channel_with_cylinder_mesh(SHARD_DD_MAXH), **kw)
    single.SolveInitial(iterative=True, GS=False, tol=jd["tol"],
                        maxsteps=3000, scale_k=jd["scale_k"])
    u_sh = torch.as_tensor(pu.to_global(res.x[0].numpy()), device="cuda")
    diff = float((u_sh + single.u_bc - single.u).abs().max())
    log(f"{tag} sharded_flagship_solve: {res.iterations} BPCG iterations "
        f"(JAX {jd['iterations']}, single device "
        f"{single.stokes_bpcg_iterations}), converged {res.converged}, "
        f"{t_call:.1f} s with the ranks' start; velocity {diff:.3e} from "
        f"the single-device solve; launches {dd_launches}")
    check(res.converged and abs(res.iterations - jd["iterations"]) <= 3,
          f"{tag}: {res.iterations} iterations, JAX {jd['iterations']}")
    check(diff <= SHARD_DD_DIFF, f"{tag}: velocity {diff:.3e} off")
    check(dd_launches.get("batched_local_matvec_f64", 0) > 0,
          f"{tag}: kernel 8 never launched in rank 0")
    secs = time.perf_counter() - t_phase
    log(f"[shard] phase {secs:.1f} s")
    return secs, launches


def shard_face_phase(torch):
    """[shard-face]: the face-sharded solve on two gloo ranks on the one
    card at SHARD_SMALL_MAXH with SHARD_SMALL_KW (the JAX package's sharded
    parity test's settings): the true f64 residual <= its tol, the inner
    count held to the JAX package's at 2 shards by ``shard_match``, kernels
    1, 2 and 8 (f64) launched in rank 0.  ``chip_smoke.py`` runs it in a
    process of its own (:func:`shard_face_start`).  Returns its seconds."""
    from navier_stokes_tpu_torch.flagship import build_model
    from navier_stokes_tpu_torch.parallel import faceshard
    from navier_stokes_tpu_torch.parallel.sharding import Ranks

    t_phase = time.perf_counter()
    ranks = Ranks(SHARD_RANKS, backend="gloo", device="cuda:0", threads=2)
    tag = f"[shard] world size {SHARD_RANKS} (gloo), maxh={SHARD_SMALL_MAXH}"
    t0 = time.perf_counter()
    with carried_cell_bases(SWEEP_SMALL_BASES):
        ms = build_model(SHARD_SMALL_MAXH, order=ORDER, nu=NU,
                         device="cuda", curved=False)
    log(f"{tag}: model {time.perf_counter() - t0:.1f} s, ndof "
        f"{ms.n}+{ms.Q.ndof}")
    t0 = time.perf_counter()
    (xu, xp), rel, passes, inner, plan = \
        faceshard.sharded_fast_flagship_solve(ms, ranks, **SHARD_SMALL_KW)
    t_call = time.perf_counter() - t0
    true = shard_true_rel(torch, ms, torch.as_tensor(xu, device="cuda"),
                          torch.as_tensor(xp, device="cuda"))
    jf = SHARD_JAX["face"]
    log(f"{tag} sharded_fast_flagship_solve: inner {inner}, passes "
        f"{passes}, driver rel {rel:.3e}, true f64 rel {true:.3e}, "
        f"{t_call:.1f} s with the ranks' start (JAX at 2 shards: inner "
        f"{jf['inner']}, passes {jf['passes']}, rel {jf['rel']:.3e}, halo "
        f"{jf['halo_rows']} against owned {jf['own_rows']})")
    shard_stats(tag, plan, inner, plan.run_stats)
    check(true <= SHARD_SMALL_KW["tol"] and math.isfinite(true),
          f"{tag}: true residual {true:.3e}")
    check(shard_match(inner, jf["inner"]),
          f"{tag}: {inner} inner iterations, JAX {jf['inner']}")
    for name in ("block_mv", "block_mv2", "batched_local_matvec_f64"):
        check(plan.run_stats["launches"].get(name, 0) > 0,
              f"{tag}: {name} never launched in rank 0")
    secs = time.perf_counter() - t_phase
    log(f"[shard-face] phase {secs:.1f} s")
    return secs


def shard_face_start(here):
    """Start ``tools/smoke_phases.py --phases shard-face`` in a process of
    its own (and its own session, so that its rank processes can be ended
    with it), its output to a temporary file; returns (process, that
    file, start time) for :func:`shard_face_wait`."""
    import tempfile

    cmd = [sys.executable, os.path.join(here, "tools", "smoke_phases.py"),
           "--phases", "shard-face"]
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(cmd, cwd=here, stdout=out,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    CHILDREN.append(proc)
    return proc, out, time.perf_counter()


def shard_face_wait(started):
    """Wait for :func:`shard_face_start`'s process, log its ``[shard]``
    lines, and fail unless it exited 0.  Returns (its seconds, the seconds
    waited here)."""
    proc, out, t_start = started
    t0 = time.perf_counter()
    proc.wait(timeout=900)
    waited = time.perf_counter() - t0
    secs = time.perf_counter() - t_start
    out.seek(0)
    lines = out.read().strip().splitlines()
    out.close()
    for line in lines:
        if line.startswith(("[shard]", "[shard-face]")):
            log(line)
    log(f"[shard-face] its process: rc {proc.returncode}, {secs:.1f} s since "
        f"its start, {waited:.1f} s of it waited for here")
    if proc.returncode != 0:
        for line in lines[-60:]:
            log(f"  [shard-face] {line}")
    check(proc.returncode == 0, f"[shard-face] exited {proc.returncode}")
    return secs, waited


def graft_phase(torch, bm, spatial=None):
    """[graft]: ``graft_entry.entry()``'s step on the card (launch
    counters set to 0 just before it: kernel 8 in f32 must launch) and on
    the CPU from the same state, held together within GRAFT_STEP_BOUND,
    their CG counts within one; then the dry run over every card of the
    machine.  ``spatial`` (default: more than one card): the whole
    ``dryrun_multichip``: rel <= TOL, the inner count held to the JAX
    package's at that world size (GRAFT_JAX; a world size without a JAX
    count is printed only), kernels 1, 2 and 8 (f64) launched in rank 0's
    solve and kernel 8 (f32) in its batch step, the batch of JAX's shape.
    Else only its data-parallel half (``graft_entry.data_parallel_half``)
    on one NCCL rank in this process, held the same way: on one card the
    spatial half is [shard]'s world-size-1 solve again.  Returns (seconds,
    the entry step's launches)."""
    from navier_stokes_tpu_torch import graft_entry

    t_phase = time.perf_counter()
    fn, (u,) = graft_entry.entry()
    fn_cpu, (u_cpu,) = graft_entry.entry(device="cpu")
    check(torch.equal(u.cpu(), u_cpu), "[graft] entry(): the card's and "
          "the CPU's models start from different states")
    bm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = fn(u)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    launches = dict(bm.LAUNCHES)
    t0 = time.perf_counter()
    y_cpu = fn_cpu(u_cpu)
    t_cpu = time.perf_counter() - t0
    it, it_cpu = fn.model.last_iterations, fn_cpu.model.last_iterations
    scale = float(y_cpu.abs().max())
    diff = float((y.cpu() - y_cpu).abs().max())
    log(f"[graft] entry(): 2D MCS maxh {graft_entry.ENTRY_MAXH}, "
        f"{tuple(y.shape)} {str(y.dtype)[6:]}; one step {t_card:.3f} s on "
        f"the card (cold), {t_cpu:.3f} s on the CPU; card against CPU "
        f"{diff:.3e} ({diff / scale:.2e} of max |u| {scale:.4f}); CG "
        f"counts card {it}, CPU {it_cpu}; launches {launches}")
    check(bool(torch.isfinite(y).all() and torch.isfinite(y_cpu).all()),
          "[graft] entry(): a step is not finite")
    check(diff <= GRAFT_STEP_BOUND * scale,
          f"[graft] entry(): card and CPU {diff:.3e} apart")
    for k in ("mstar", "project"):
        check(abs(int(it[k]) - int(it_cpu[k])) <= 1,
              f"[graft] entry(): {k} CG {it[k]} on the card, {it_cpu[k]} "
              "on the CPU")
    check(launches.get("batched_local_matvec", 0) > 0,
          "[graft] entry(): kernel 8 (f32) never launched")

    n = torch.cuda.device_count()
    if spatial is None:
        spatial = n > 1
    if not spatial:
        import torch.distributed as dist

        from navier_stokes_tpu_torch.parallel.sharding import single_rank

        tag = "[graft] data_parallel_half(one NCCL rank)"
        t0 = time.perf_counter()
        mesh = single_rank("nccl")
        try:
            batch = graft_entry.data_parallel_half(mesh)
        finally:
            dist.destroy_process_group()
        shape = tuple(batch["out"].shape)
        log(f"{tag}: {time.perf_counter() - t0:.1f} s; batch {shape}, CG "
            f"{batch['iterations']}; launches {batch['launches']} (the "
            "spatial half at world size 1 is [shard]'s world-size-1 solve: "
            "tools/smoke_phases.py --phases graft runs it)")
        check(bool(torch.isfinite(batch["out"]).all()),
              f"{tag}: the batch is not finite")
        check(batch["launches"].get("batched_local_matvec", 0) > 0,
              f"{tag}: kernel 8 (f32) never launched in the batch step")
        check(shape[0] == 1, f"{tag}: batch {shape}")
        secs = time.perf_counter() - t_phase
        log(f"[graft] phase {secs:.1f} s")
        return secs, launches
    tag = f"[graft] dryrun_multichip({n})"
    t0 = time.perf_counter()
    with carried_cell_bases(SWEEP_SMALL_BASES):
        out = graft_entry.dryrun_multichip(n)
    t_dry = time.perf_counter() - t0
    stats = out["run_stats"]
    jax = GRAFT_JAX.get(n)
    log(f"{tag}: {t_dry:.1f} s (model {out['model_seconds']:.1f} s, solve "
        f"call {out['solve_seconds']:.1f} s: rank 0's solve "
        f"{stats['solve_seconds']:.3f} s); inner {out['inner']}, passes "
        f"{out['passes']}, rel {out['rel']:.3e}; halo {out['halo_rows']} "
        f"against owned {out['own_rows']}; batch {out['batch_shape']}, CG "
        f"{out['batch_iterations']}; launches: solve {stats['launches']}, "
        f"batch {out['batch_launches']}; collective calls "
        f"{stats['collectives']}"
        + (f" (JAX at {n}: inner {jax['inner']}, passes {jax['passes']}, "
           f"rel {jax['rel']:.3e}, halo {jax['halo_rows']} against owned "
           f"{jax['own_rows']})" if jax else
           f" (no JAX count recorded at world size {n}: not held)"))
    check(out["rel"] <= TOL, f"{tag}: rel {out['rel']:.3e}")
    if jax:
        check(shard_match(out["inner"], jax["inner"]),
              f"{tag}: {out['inner']} inner iterations, JAX {jax['inner']}")
    for name in ("block_mv", "block_mv2", "batched_local_matvec_f64"):
        check(stats["launches"].get(name, 0) > 0,
              f"{tag}: {name} never launched in rank 0's solve")
    check(out["batch_launches"].get("batched_local_matvec", 0) > 0,
          f"{tag}: kernel 8 (f32) never launched in the batch step")
    check(out["batch_shape"][0] == n, f"{tag}: batch {out['batch_shape']}")
    secs = time.perf_counter() - t_phase
    log(f"[graft] phase {secs:.1f} s")
    return secs, launches


def dd3d_phase(torch, bm, lm, timer, gen, reports):
    """[dd3d]: the dd solve's 3D branch (the face+interior block smoother)
    on the JAX test's model (tests/test_parallel.py:127-153) at world size
    1 (NCCL, this process): kernel 8 (f64) on the rank's A, B, B^T
    (rectangular, as they are) and block-inverse tables against its plain
    version, then ``ddshard.sharded_flagship_solve`` to DD3D_TOL with the
    launch counters set to 0 just before it (kernel 8 in f64 must launch),
    and the model's own ``SolveInitial(iterative=True, GS=False)``; the JAX
    test's bounds between the two.  Returns (seconds, the sharded solve's
    launches)."""
    import numpy as np
    import torch.distributed as dist

    from navier_stokes_tpu_torch.flagship import uin
    from navier_stokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_mesh_3d,
    )
    from navier_stokes_tpu_torch.models import NavierStokesMCS
    from navier_stokes_tpu_torch.parallel import ddshard
    from navier_stokes_tpu_torch.parallel.sharding import single_rank

    t_phase = time.perf_counter()
    tag = f"[dd3d] maxh={DD3D_MAXH}, world size 1"
    t0 = time.perf_counter()
    with carried_cell_bases(SWEEP_SMALL_BASES):
        ns = NavierStokesMCS(
            channel_with_cylinder_mesh_3d(DD3D_MAXH), nu=NU, inflow="inlet",
            outflow="outlet", wall="wall|cyl", uin=uin, timestep=2e-3,
            order=ORDER, preconditioner="faceblock", dtype=torch.float64,
            device="cuda")
    log(f"{tag}: model {time.perf_counter() - t0:.1f} s, ndof "
        f"{ns.n}+{ns.Q.ndof}")
    mesh = single_rank("nccl")
    try:
        t0 = time.perf_counter()
        bundles, _, _ = ddshard.dd_flagship_tables(ns, 1)
        log(f"{tag}: dd tables {time.perf_counter() - t0:.1f} s")
        rep = reports["batched_local_matvec_f64_dd3d"]
        for k in ("A", "B", "BT", "pre"):
            T = ddshard.rank_dd_operator(bundles[0]["ops"][k], mesh).table
            check_local_mv(torch, lm, timer, rep, f"dd3d {k}", T, gen)
        del bundles
        bm.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, pu, _ = ddshard.sharded_flagship_solve(
            ns, mesh, tol=DD3D_TOL, maxsteps=DD3D_MAXSTEPS)
        torch.cuda.synchronize()
        t_sh = time.perf_counter() - t0
        launches = dict(bm.LAUNCHES)
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    ns.SolveInitial(iterative=True, GS=False, tol=DD3D_TOL,
                    maxsteps=DD3D_MAXSTEPS)
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    single = ns.stokes_bpcg_iterations
    u = ns.u.cpu().numpy()
    u_sh = pu.to_global(res.x[0].cpu().numpy()) + ns.u_bc.cpu().numpy()
    diff = float(np.abs(u_sh - u).max() / np.abs(u).max())
    k8 = launches.get("batched_local_matvec_f64", 0)
    log(f"{tag}: sharded_flagship_solve {res.iterations} BPCG iterations, "
        f"converged {res.converged}, {t_sh:.3f} s with its tables; "
        f"SolveInitial {single} ({t_single:.3f} s, k "
        f"{ns.stokes_bpcg_scale_k:.3f}); velocity {diff:.3e} of max |u| "
        f"apart; kernel-8 launches {k8} ({k8 / max(res.iterations, 1):.2f} "
        f"per BPCG iteration); launches {launches} (JAX: single "
        f"{DD3D_JAX['single']}, sharded {DD3D_JAX['sharded']} at its own k "
        f"{DD3D_JAX['scale_k']:.3f}, {DD3D_JAX['diff']:.3e} apart)")
    check(res.converged and single < DD3D_MAXSTEPS,
          f"{tag}: a solve did not converge")
    check(abs(res.iterations - single) <= max(5, 0.02 * single),
          f"{tag}: sharded {res.iterations} against single {single}")
    check(diff < DD3D_DIFF, f"{tag}: velocity {diff:.3e} apart")
    check(k8 > 0, f"{tag}: kernel 8 (f64) never launched")
    secs = time.perf_counter() - t_phase
    log(f"[dd3d] phase {secs:.1f} s")
    return secs, launches


def skeleton_slow_phase(torch, bm, lm, timer, gen, reports):
    """[skeleton-slow]: the dof-level skeleton preconditioner
    (``build_skeleton_preconditioner_3d(fast=False)``) on the straight
    channel at maxh 0.35 (tests/test_skeleton_fast.py's), all tables f64,
    the reference's unsymmetrized tables and coarse target 0.9, additive and
    GS.  Each built on the card is held to the same preconditioner built
    with ``device="cpu"`` (every wrapper its plain version) within 1e-12
    relative on a seeded vector, and to the fast path by the CPU test's
    bounds (additive 1e-7; GS a gap under 0.5 and both symmetric to 1e-8);
    kernel 8 in f64 must launch when the counters, set to 0 just before,
    are read after one apply of each; its square tables are checked
    against the plain version.  Returns (seconds, launches)."""
    import numpy as np

    from navier_stokes_tpu_torch.flagship import build_model
    from navier_stokes_tpu_torch.models.auxspace3d import (
        build_skeleton_preconditioner_3d as build,
    )
    from navier_stokes_tpu_torch.utils.timers import per_apply_ms

    t_phase = time.perf_counter()
    f64 = torch.float64
    m = build_model(SLOW_MAXH, order=ORDER, nu=NU, device="cuda",
                    curved=False)
    kw = dict(coarse_coefficient=m.nu, ext_dtype=f64, inv_dtype=f64,
              panel_dtype=f64, sweep_dtype=f64, coarse_target=0.9,
              symmetrize=False)
    log(f"[skeleton-slow] straight channel at maxh {SLOW_MAXH}: {m.mesh.ne} "
        f"tets, ndof {m.n}; model {time.perf_counter() - t_phase:.1f} s")
    rng = np.random.default_rng(5)
    x_cpu = torch.as_tensor(rng.standard_normal(m.n))
    x = x_cpu.to("cuda")
    a = x * m.free
    b = torch.as_tensor(rng.standard_normal(m.n), device="cuda") * m.free
    built = {}
    for gs in (False, True):
        secs = []
        for dev, fast in (("cpu", False), ("cuda", False), ("cuda", True)):
            t0 = time.perf_counter()
            built[gs, dev, fast] = build(m.Xv, m.A_cond_np, m._dirich, dev,
                                         f64, gs=gs, fast=fast, **kw)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        log(f"[skeleton-slow] {'GS' if gs else 'additive'} setup: slow on the "
            f"CPU {secs[0]:.1f} s, slow on the card {secs[1]:.1f} s, fast on "
            f"the card {secs[2]:.1f} s")
    bm.reset_launches()
    torch.cuda.synchronize()
    ys = {gs: built[gs, "cuda", False](x) for gs in (False, True)}
    torch.cuda.synchronize()
    launches = dict(bm.LAUNCHES)
    log(f"[skeleton-slow] launches of one slow apply each: {launches}")
    check(launches["batched_local_matvec_f64"] > 0,
          "batched_local_matvec_f64 never launched on the dof-level path")

    def rel(p, q):
        return float(torch.linalg.norm(p - q) / torch.linalg.norm(q))

    def asym(pre):
        lhs, rhs = float(torch.dot(pre(a), b)), float(torch.dot(a, pre(b)))
        return abs(lhs - rhs) / max(abs(lhs), 1.0)

    for gs in (False, True):
        tag = "GS" if gs else "additive"
        slow, fast = built[gs, "cuda", False], built[gs, "cuda", True]
        card_cpu = rel(ys[gs].cpu(), built[gs, "cpu", False](x_cpu))
        gap = rel(fast(x), ys[gs])
        syms = (asym(slow), asym(fast))
        ms_slow, ms_fast = per_apply_ms(slow, x), per_apply_ms(fast, x)
        log(f"[skeleton-slow] {tag}: card against CPU {card_cpu:.3e}, fast "
            f"against slow {gap:.3e}, asymmetry slow {syms[0]:.2e} fast "
            f"{syms[1]:.2e}; per apply slow {ms_slow:.4f} ms, fast "
            f"{ms_fast:.4f} ms")
        check(card_cpu <= SLOW_CARD_CPU, f"[skeleton-slow] {tag}: the card "
              f"is {card_cpu:.3e} from the CPU build")
        if gs:
            check(gap < 0.5 and max(syms) < 1e-8, f"[skeleton-slow] GS: gap "
                  f"{gap:.3e}, asymmetry {max(syms):.2e}")
        else:
            check(gap < 1e-7, f"[skeleton-slow] additive: fast against slow "
                  f"{gap:.3e}")
        log(f"[kernels] batched_local_matvec on the {tag} dof-level tables")
        for name, T in slow.parts["tables"].items():
            if T.shape[-1] == T.shape[-2]:
                check_local_mv(torch, lm, timer,
                               reports["batched_local_matvec_f64_skeleton"],
                               f"skeleton {tag} {name}", T, gen)
    del built, m
    return time.perf_counter() - t_phase, launches


def probes_phase(solver, m32):
    """[probes]: the three attribution scripts of
    ``navier_stokes_tpu_torch/scripts`` at maxh 0.09 on the smoke's own
    flagship ``solver`` and f32 twin ``m32``, their lines logged:
    ``microbench_sweep`` (each preA piece by graph replay and eagerly, each
    GS color step and its row gathers' share), ``probe_transient`` (the
    step's pieces from u_bc; its CG counts must equal the step's) and
    ``audit_tables`` (which raises unless the launches of one preA apply
    equal its stream counts).  Returns seconds."""
    import contextlib
    import io

    from navier_stokes_tpu_torch.scripts import (
        audit_tables,
        microbench_sweep,
        probe_transient,
    )

    t_phase = time.perf_counter()

    def run(name, fn):
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                return fn()
        finally:
            for line in buf.getvalue().splitlines():
                log(f"[probes {name}] {line}")

    rows = run("microbench_sweep",
               lambda: microbench_sweep.main(MAXH, solver=solver))
    check(all(r["replay_ms"] > 0 for r in rows),
          "[probes] a sweep piece's graph replay took no time")
    colors = [r for r in rows if r["piece"].startswith("color ")]
    step_ms = sum(r["replay_ms"] for r in colors)
    gather_ms = sum(r["gather_ms"] for r in colors)
    log(f"[probes] the {len(colors)} GS color steps once each: "
        f"{step_ms:.4f} ms by graph replay, their row gathers alone "
        f"{gather_ms:.4f} ms ({gather_ms / step_ms:.3f})")
    rows = run("probe_transient",
               lambda: probe_transient.main(MAXH, m=m32))
    check_probe_rows(rows, "[probes]")
    audit = run("audit_tables",
                lambda: audit_tables.main(MAXH, solver=solver))
    check(audit["launches"], "[probes] the audit counted no launches")
    return time.perf_counter() - t_phase


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

    # 2. the card-only tests, from the repository alone (no JAX), in a
    # process of their own beside the setup's host work; waited for
    # before the first timed kernel check
    cuda_tests = cuda_tests_start(here)

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
    # the setup seconds are taken beside [cuda-tests] on the same card
    log(f"[setup] (beside [cuda-tests]) curved GS: mesh {t_mesh:.1f} s, "
        f"curve {t_curve:.1f} s, "
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
    log(f"[setup] (beside [cuda-tests]) straight additive: model build "
        f"{t_model_s:.1f} s, "
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
    log(f"[setup] (beside [cuda-tests]) transient f32: model build "
        f"{t_model32:.1f} s (host tables "
        f"shared), step setup {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in m32.setup_seconds.items())
        + f"; Chebyshev bounds ({alpha:.5f}, {beta:.5f})")
    check(m32.dtype == torch.float32 and m32.u.dtype == torch.float32,
          "the stepping model is not float32")
    check(m32.n == m.n and m32.Q.ndof == m.Q.ndof, "the twin differs in size")

    t_cuda_tests = cuda_tests_phase(here, cuda_tests)

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
        # the 2D models' tables ([mcs2d], [th2d]): kernel 8 in f64 on the
        # element tables, the MCS vertex stars and the Taylor-Hood patches
        "batched_local_matvec_f64_mcs2d": KernelReport(
            "batched_local_matvec_f64_mcs2d", f"{PALLAS_LOCAL}:26",
            SRC_LOCAL, F64_FLOPS_PER_S),
        "batched_local_matvec_f64_th2d": KernelReport(
            "batched_local_matvec_f64_th2d", f"{PALLAS_LOCAL}:26",
            SRC_LOCAL, F64_FLOPS_PER_S),
        # the Stokes catalog's and the heat model's tables ([stokes],
        # [heat]): kernel 8 in f64 on the HDG, mixed and MCS element tables
        # and the edgeblock inverses, and on heat's mass and stiffness
        "batched_local_matvec_f64_stokes": KernelReport(
            "batched_local_matvec_f64_stokes", f"{PALLAS_LOCAL}:26",
            SRC_LOCAL, F64_FLOPS_PER_S),
        "batched_local_matvec_f64_heat": KernelReport(
            "batched_local_matvec_f64_heat", f"{PALLAS_LOCAL}:26",
            SRC_LOCAL, F64_FLOPS_PER_S),
        # the Reynolds-number ensemble's tables ([sweep]): kernel 8 in f64
        # on the nu-split tables G1, G2, G3 and the mass of the 3D step
        "batched_local_matvec_f64_sweep": KernelReport(
            "batched_local_matvec_f64_sweep", f"{PALLAS_LOCAL}:26",
            SRC_LOCAL, F64_FLOPS_PER_S),
        # the face-sharded solve's tables ([shard], world size 1): kernel 1
        # on the preconditioner's, kernel 2 on the split A, B, B^T pairs,
        # kernel 8 in f64 on the residual A
        "block_mv_shard": KernelReport("block_mv_shard", f"{PALLAS}:118"),
        "block_mv2_shard": KernelReport("block_mv2_shard", f"{PALLAS}:124"),
        "batched_local_matvec_f64_shard": KernelReport(
            "batched_local_matvec_f64_shard", f"{PALLAS_LOCAL}:26",
            SRC_LOCAL, F64_FLOPS_PER_S),
        # the dof-level skeleton preconditioner ([skeleton-slow]): kernel 8
        # in f64 on its interior, S, block-Jacobi and GS block tables
        "batched_local_matvec_f64_skeleton": KernelReport(
            "batched_local_matvec_f64_skeleton", f"{PALLAS_LOCAL}:26",
            SRC_LOCAL, F64_FLOPS_PER_S),
        # the dd solve's 3D branch ([dd3d]): kernel 8 in f64 on the rank's
        # A, B, B^T and face+interior block-inverse tables
        "batched_local_matvec_f64_dd3d": KernelReport(
            "batched_local_matvec_f64_dd3d", f"{PALLAS_LOCAL}:26",
            SRC_LOCAL, F64_FLOPS_PER_S),
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

    # 12c. the Reynolds-number ensemble on the curved f64 model
    t_sweep, launches_sweep = sweep_phase(torch, bm, lm, timer, gen, reports,
                                          m, m.u_bc + warm.x[0])

    # 12d. the sharded solves on torch.distributed
    t_shard, launches_shard = shard_phase(torch, bm, lm, timer, gen,
                                          reports, m)

    # 13. the port's bench line on the models already built
    bench_line, t_bench = bench_phase(bench, m, m32, cold, warm, card)

    # 13b. the 2-phase MINRES refinement driver on the main path's model
    t_refine = refine_phase(torch, bm, solver)

    # 13c. the attribution scripts on the flagship solver and the f32 twin
    t_probes = probes_phase(solver, m32)

    # 13d. the dof-level skeleton preconditioner at maxh 0.35
    t_slow, launches_slow = skeleton_slow_phase(torch, bm, lm, timer, gen,
                                                reports)

    # 14. the ported microbenchmark scripts
    t0 = time.perf_counter()
    launches_mb = microbench_phase(bm)
    t_mb = time.perf_counter() - t0

    # 15. the SA-AMG coarse solve on a mesh above the dense limit
    # with the two-rank face-sharded solve of [shard] beside its host setup
    t0 = time.perf_counter()
    t_face, t_face_waited = amg_phase(
        torch, bm, build_model, FlagshipSolve, cylinder_geometry,
        shard_face=shard_face_start(here))
    t_amg = time.perf_counter() - t0

    # 16. the 3D HDG model: the models of the MCS paths are let go first
    del solver, solver_s, solver_k, m_s, step32, m32, m
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t_hdg, launches_hdg, launches_ref = hdg3d_phase(torch, bm, lm, timer, gen,
                                                    reports)
    gc.collect()
    torch.cuda.empty_cache()

    # 17. the 2D models: MCS (maxh 0.05 and 0.01) and Taylor-Hood
    t_mcs2d, launches_mcs2d = mcs2d_phase(torch, bm, lm, timer, gen, reports)
    t_th2d, launches_th2d = th2d_phase(torch, bm, lm, timer, gen, reports)

    # 18. the Stokes catalog and the heat model
    gc.collect()
    torch.cuda.empty_cache()
    t_stokes, launches_stokes = stokes_phase(torch, bm, lm, timer, gen,
                                             reports, here)
    t_heat, launches_heat = heat_phase(torch, bm, lm, timer, gen, reports)

    # 19. the parameter-sweep harness run_ns_sweep
    t_ns_sweep, _ = ns_sweep_phase(torch, bm, here)

    # 21. __graft_entry__'s entry points, then the dd solve's 3D branch
    t_graft, _ = graft_phase(torch, bm)
    t_dd3d, launches_dd3d = dd3d_phase(torch, bm, lm, timer, gen, reports)

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
              "block_mv_hdg3d": launches_ref.get("block_mv", 0),
              "batched_local_matvec_f64_mcs2d":
                  launches_mcs2d.get("batched_local_matvec_f64", 0),
              "batched_local_matvec_f64_th2d":
                  launches_th2d.get("batched_local_matvec_f64", 0),
              "batched_local_matvec_f64_stokes":
                  launches_stokes.get("batched_local_matvec_f64", 0),
              "batched_local_matvec_f64_heat":
                  launches_heat.get("batched_local_matvec_f64", 0),
              "batched_local_matvec_f64_sweep":
                  launches_sweep.get("batched_local_matvec_f64", 0),
              "block_mv_shard": launches_shard.get("block_mv", 0),
              "block_mv2_shard": launches_shard.get("block_mv2", 0),
              "batched_local_matvec_f64_shard":
                  launches_shard.get("batched_local_matvec_f64", 0),
              "batched_local_matvec_f64_skeleton":
                  launches_slow.get("batched_local_matvec_f64", 0),
              "batched_local_matvec_f64_dd3d":
                  launches_dd3d.get("batched_local_matvec_f64", 0)}
    kernels = {"kernels": [rep.entry(counts[name])
                           for name, rep in reports.items()]}
    redesign_order(kernels["kernels"], reports)
    log(f"[time] phases: cuda-tests {t_cuda_tests:.1f} s, bpcg "
        f"{t_bpcg:.1f} s, bench {t_bench:.1f} s, repeat {t_repeat:.1f} s, "
        f"refine {t_refine:.1f} s, hdg3d {t_hdg:.1f} s, mcs2d "
        f"{t_mcs2d:.1f} s, th2d {t_th2d:.1f} s, stokes {t_stokes:.1f} s, "
        f"heat {t_heat:.1f} s, sweep {t_sweep:.1f} s, ns-sweep "
        f"{t_ns_sweep:.1f} s, shard {t_shard:.1f} s, shard-face "
        f"{t_face:.1f} s beside [amg] ({t_face_waited:.1f} s waited for), "
        f"amg {t_amg:.1f} s, probes {t_probes:.1f} s, skeleton-slow {t_slow:.1f} s; new: microbench "
        f"{t_mb:.1f} s, graft {t_graft:.1f} s, dd3d {t_dd3d:.1f} s; whole "
        f"run {time.perf_counter() - T_START:.1f} s")
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
    finally:
        for proc in CHILDREN:  # each in a session of its own, with its ranks
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()


if __name__ == "__main__":
    sys.exit(main())

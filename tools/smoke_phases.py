"""Run chosen phases of ``chip_smoke.py`` on the card, alone.

Builds the kernels, prints the card's name and power limit, then runs the
phases named by ``--phases`` (in that order) with chip_smoke.py's own
phase functions and checks: ``cuda-tests`` (the card-only tests),
``stokes`` (the Stokes catalog: ``[stokes]``), ``heat`` (the heat model:
``[heat]``, with ``--heat-steps`` time steps of the convergence study:
chip_smoke.py runs 3, this tool can run all 5), ``sweep`` (the
Reynolds-number ensemble: ``[sweep]`` on the curved f64 model at maxh 0.09,
built here, from u = u_bc where chip_smoke.py starts from the flagship
solution), ``ns-sweep`` (the parameter-sweep harness:
``[ns-sweep]``) and ``shard`` (the sharded solves on torch.distributed:
``[shard]``, on the curved f64 model at maxh 0.09 built here).  Prints the
kernels' JSON entries of the phases run.  Exits 1 when a phase fails.

    python3 tools/smoke_phases.py [--phases cuda-tests,stokes,heat]
        [--heat-steps 5]
    python3 tools/smoke_phases.py --phases sweep,ns-sweep
    python3 tools/smoke_phases.py --phases shard
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="cuda-tests,stokes,heat")
    ap.add_argument("--heat-steps", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from navier_stokes_tpu_torch.ops import block_mv as bm
    from navier_stokes_tpu_torch.ops import local_mv as lm
    from navier_stokes_tpu_torch.utils.timers import KernelTimer

    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    built = bm.build_all()
    lm.load_library()
    cs.log("[build] " + ", ".join(f"{p.name}: nvcc {s:.1f} s"
                                  for p, s in built.values())
           + f" (with load {time.perf_counter() - t0:.1f} s)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    cs.log(f"[card] {card}")
    timer = KernelTimer()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    names = {"stokes": "batched_local_matvec_f64_stokes",
             "heat": "batched_local_matvec_f64_heat",
             "sweep": "batched_local_matvec_f64_sweep"}
    reports = {n: cs.KernelReport(n, f"{cs.PALLAS_LOCAL}:26", cs.SRC_LOCAL,
                                  cs.F64_FLOPS_PER_S)
               for n in list(names.values())
               + ["batched_local_matvec_f64_shard"]}
    reports["block_mv_shard"] = cs.KernelReport("block_mv_shard",
                                                f"{cs.PALLAS}:118")
    reports["block_mv2_shard"] = cs.KernelReport("block_mv2_shard",
                                                 f"{cs.PALLAS}:124")
    entries = []
    try:
        for phase in args.phases.split(","):
            if phase == "cuda-tests":
                cs.cuda_tests_phase(ROOT)
                continue
            if phase == "stokes":
                secs, launches = cs.stokes_phase(torch, bm, lm, timer, gen,
                                                 reports, ROOT)
            elif phase == "heat":
                n = args.heat_steps or cs.HEAT_RUN
                secs, launches = cs.heat_phase(torch, bm, lm, timer, gen,
                                               reports, n_steps=n)
            elif phase == "sweep":
                from navier_stokes_tpu_torch.flagship import build_model

                t0 = time.perf_counter()
                m = build_model(cs.MAXH, order=cs.ORDER, nu=cs.NU,
                                device="cuda")
                cs.log(f"[sweep] curved model at maxh {cs.MAXH}: "
                       f"{time.perf_counter() - t0:.1f} s")
                secs, launches = cs.sweep_phase(torch, bm, lm, timer, gen,
                                                reports, m, m.u_bc)
                del m
            elif phase == "shard":
                from navier_stokes_tpu_torch.flagship import build_model

                t0 = time.perf_counter()
                m = build_model(cs.MAXH, order=cs.ORDER, nu=cs.NU,
                                device="cuda")
                cs.log(f"[shard] curved model at maxh {cs.MAXH}: "
                       f"{time.perf_counter() - t0:.1f} s")
                secs, launches = cs.shard_phase(torch, bm, lm, timer, gen,
                                                reports, m)
                del m
                for name, key in (("block_mv_shard", "block_mv"),
                                  ("block_mv2_shard", "block_mv2"),
                                  ("batched_local_matvec_f64_shard",
                                   "batched_local_matvec_f64")):
                    entries.append(reports[name].entry(launches.get(key, 0)))
                cs.log(f"[time] {phase} {secs:.1f} s")
                continue
            elif phase == "ns-sweep":
                secs, _ = cs.ns_sweep_phase(torch, bm, ROOT)
                cs.log(f"[time] {phase} {secs:.1f} s")
                continue
            else:
                raise ValueError(f"unknown phase {phase!r}")
            rep = reports[names[phase]]
            entries.append(rep.entry(launches.get("batched_local_matvec_f64",
                                                  0)))
            cs.log(f"[time] {phase} {secs:.1f} s")
    except cs.Fail as e:
        print(f"smoke_phases FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": entries}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

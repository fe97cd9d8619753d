"""The readings that the limits of ``correct`` were set from: for each seed,
the program's reading of every number a cell compares and the control's
(the reference in the precision below the configuration's, or the
program's state held in it; see each configuration's ``control``).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--maxh H]

Each seed builds the cell as a run does, runs a short window of whole units
at the cell's own load, and prints one JSON line per seed.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from perfbench.harness import Parts, load_cell, log  # noqa: E402


def readings(workload: str, seed: int, seconds: float, device="cuda",
             overrides: dict | None = None) -> dict:
    """{name: {"program": x, "control": y}} for one seed."""
    import torch

    cell = load_cell(workload)
    spec = {**cell["spec"], **(overrides or {})}
    mod = cell["module"]
    on_cuda = torch.device(device).type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    system = mod.System(spec, seed, cell["traffic"], device, Parts(sync))
    t0 = time.perf_counter()
    n = 0
    while True:
        system.run_unit()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    material = system.release(np.random.default_rng([seed, 1]))
    del system
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    out = {name: {"program": p, "control": c}
           for name, p, c in mod.control(spec, material, device, log=log)}
    return {"seed": seed, "units": n, "um": material["um"], "readings": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--maxh", type=float, default=None)
    args = ap.parse_args(argv)
    over = {"maxh": args.maxh} if args.maxh else None
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  overrides=over)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

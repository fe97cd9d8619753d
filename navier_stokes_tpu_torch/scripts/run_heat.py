"""Heat-equation convergence study on the port -- the reference heat.py's
module-level harness: time steps logspace(-1, -4, 7), end time 0.05,
order-10 H1 on the unit square (maxh 0.1), L2 error against the exact
eigenfunction-decay solution, written to heat_errors.csv (the schema of
heat.py:151-167).

Counterpart of the JAX package's ``scripts/run_heat.py``; ``-q`` runs the
quick study (order 6, maxh 0.2, time steps down to 10^-2.5).  Runs on the
card; ``--device cpu`` for a small check on the CPU.

    python -m navier_stokes_tpu_torch.scripts.run_heat [-q] [out.csv]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..models import heat_convergence_study


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("data_file", nargs="?", default="heat_errors.csv")
    ap.add_argument("-q", dest="quick", action="store_true",
                    help="order 6, maxh 0.2, time steps down to 10^-2.5")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, required)")
    args = ap.parse_args(argv)
    kwargs = (dict(order=6, maxh=0.2) if args.quick
              else dict(order=10, maxh=0.1))
    ts = np.logspace(-1, -2.5 if args.quick else -4, num=7).tolist()
    rows = heat_convergence_study(time_steps=ts, data_file=args.data_file,
                                  device=args.device, **kwargs)
    print(f"{'time_step':>12s} {'error':>24s}")
    for r in rows:
        print(f"{r['time_step']:12.6g} {r['error']:24.17g}")
    print("wrote", args.data_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Stokes benchmark sweep on the port -- the reference run.py's harness.

Counterpart of the JAX package's ``scripts/run_stokes.py``, with the same
active configuration (the reference's module literals, run.py:265-296):
every mixed entry commented out, "HDG BDM 2" on the order-3 curved
cylinder with Bramble-Pasciak CG to 1e-7 active, at maxh 0.1.  Uncomment
entries below to widen the sweep to the full catalog.  Runs on the card;
``--device cpu`` for a small check on the CPU.

    python -m navier_stokes_tpu_torch.scripts.run_stokes [-p] [out.csv]
        [--device cpu]

  -p        record a torch.profiler trace of each solve (the reference's
            pajetrace flag, run.py:218-219)
  out.csv   output file (default errors.csv, run.py:222-224)
"""

from __future__ import annotations

import argparse
import sys

from ..mesh.curved import curve_to_circle
from ..models import stokes as st
from ..models.discretizations import (  # noqa: F401  (the sweep's catalog)
    P1_nonconforming_velocity_constant_pressure,
    P2_velocity_constant_pressure,
    P2_velocity_with_cubic_bubbles_linear_pressure,
    bdm_hybrid,
    hcurldiv,
    mini,
    rt_hybrid,
    taylor_hood,
)
from ..models.stokes_hybrid import solve_hybrid
from ..models.stokes_mcs import solve_hcurldiv

mesh_sizes = [0.1]  # , 0.05, 0.025, 0.01]


def methods(device=None):
    """The three solve families with the reference's ACTIVE configuration
    (run.py:265-296: every mixed entry commented out, "HDG BDM 2" active,
    MINRES commented out); uncomment entries to widen the sweep."""
    return {
        "mixed": {
            "solve": lambda mesh, disc, solver: st.solve(
                mesh, disc, solver, device=device),
            "discretizations": {
                # "P1nc, P0": P1_nonconforming_velocity_constant_pressure(),
                # "mini": mini(),
                # "P2, P0": P2_velocity_constant_pressure(),
                # "P2+, P1": P2_velocity_with_cubic_bubbles_linear_pressure(),
                # "taylor hood 2": taylor_hood(2),
                # "taylor hood 3": taylor_hood(3),
            },
        },
        "hybrid_dg": {
            # order-3 curved cylinder like the reference (run.py:28)
            "solve": lambda mesh, disc, solver: solve_hybrid(
                mesh, disc, solver,
                geometry=curve_to_circle(mesh, "cyl", (0.2, 0.2), 0.05, 3),
                device=device,
            ),
            "discretizations": {
                "HDG BDM 2": bdm_hybrid(2, 10),
                # "HDG RT 1": rt_hybrid(1, 10),
            },
        },
        "mcs": {
            "solve": lambda mesh, disc, solver: solve_hcurldiv(mesh, disc,
                                                               solver),
            "discretizations": {
                # "MCS RT 2": hcurldiv(2),
            },
        },
    }


solver_factories = {
    "bramble pasciak cg": lambda system: st.solve_with_bramble_pasciak_cg(
        system, tolerance=1e-7, max_steps=10000
    ),
    # "minres": lambda system: st.solve_with_min_res(
    #     system, tolerance=1e-7, max_steps=10000
    # ),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("data_file", nargs="?", default="errors.csv")
    ap.add_argument("-p", dest="profiling", action="store_true",
                    help="record a torch.profiler trace of each solve")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, required)")
    args = ap.parse_args(argv)
    print("profiling_enabled:", args.profiling)
    print("data file:", args.data_file)
    st.run(mesh_sizes, methods(args.device), solver_factories,
           args.data_file, args.profiling)
    return 0


if __name__ == "__main__":
    sys.exit(main())

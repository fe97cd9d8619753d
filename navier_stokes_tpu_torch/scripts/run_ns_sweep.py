"""Navier-Stokes initial-Stokes-solve parameter sweep on the port -- the
reference's templates/run_navier_stokes_parameter_sweep.py.

Counterpart of the JAX package's ``scripts/run_ns_sweep.py``: sweeps mesh
size x order x Gauss-Seidel and records the BPCG iteration count and time of
the initial steady Stokes solve (tol 1e-10) into a CSV with the reference
schema: an unnamed index column, then ``mesh_size, order, iterations, time,
gauss_seidel_enabled`` (run_navier_stokes_parameter_sweep.py:44-70),
rewritten after every configuration.  One model is reused across both GS
settings per (h, p), like the reference (:53-56).  The 2D MCS model by
default; ``--taylor-hood`` takes the Taylor-Hood pair.  Runs on the card;
``--cpu`` runs it on the CPU.  The CSV goes to ``--out``, by default
``build/ns_sweep/data.csv`` under the working directory (never over the
repository's own data.csv, the JAX package's record).

    python -m navier_stokes_tpu_torch.scripts.run_ns_sweep [full]
        [--taylor-hood] [--cpu] [--out build/ns_sweep/data.csv]

  full     the reference's whole grid, h = 2^0..2^-5 x order 2..7 (72
           solves, cheapest first); default: h = 2^-3..2^-1 x order 3, 2
           (MCS) or 4..2 (Taylor-Hood)
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..mesh.generators import channel_with_cylinder_mesh
from ..models import NavierStokes, NavierStokesMCS
from ..utils.csvfile import write_csv

COLUMNS = ("mesh_size", "order", "iterations", "time",
           "gauss_seidel_enabled")
DEFAULT_OUT = os.path.join("build", "ns_sweep", "data.csv")


def uin(p):
    out = np.zeros((len(p), 2))
    out[:, 0] = 1.5 * 4 * p[:, 1] * (0.41 - p[:, 1]) / 0.41**2
    return out


def solve(mesh_size: float, order: int, gauss_seidel: bool,
          ns_cache: dict, mcs: bool = True, device=None, scale_k=None,
          result: list | None = None) -> tuple[int, float]:
    """(BPCG iterations, seconds) of one initial Stokes solve.  One model
    is reused across both GS settings per (h, p) (at most one is kept
    alive); ``mcs`` picks the MCS model, else Taylor-Hood.  ``scale_k``:
    the Bramble-Pasciak k (the model's own Lanczos estimate when None);
    ``result``: a list that receives the solver's result."""
    key = (mesh_size, order)
    if key not in ns_cache:
        mesh = channel_with_cylinder_mesh(mesh_size)
        ns_cache.clear()  # keep at most one model alive (memory)
        cls = NavierStokesMCS if mcs else NavierStokes
        ns_cache[key] = cls(
            mesh, nu=0.001, inflow="inlet", outflow="outlet",
            wall="wall|cyl", uin=uin, timestep=1e-3, order=order,
            device=device,
        )
    ns = ns_cache[key]
    res = ns.SolveInitial(iterative=True, GS=gauss_seidel, tol=1e-10,
                          scale_k=scale_k)
    if result is not None:
        result.append(res)
    return ns.stokes_bpcg_iterations, ns.stokes_bpcg_time


def grid(full: bool, mcs: bool) -> tuple[list[float], list[int]]:
    """(mesh sizes, orders) of the sweep: the reference's h = 2^0..2^-5 x
    order 2..7 (run_navier_stokes_parameter_sweep.py:44-45), cheapest
    first, or the default subset."""
    mesh_sizes = [2.0**-e for e in ([0, 1, 2, 3, 4, 5] if full
                                    else [3, 2, 1])]
    orders = list(range(2, 8)) if full else ([3, 2] if mcs else [4, 3, 2])
    return mesh_sizes, orders


def main(argv=None) -> list[dict]:
    """Run the sweep; returns its rows (dicts of ``COLUMNS``), as written
    to the CSV."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("full", nargs="?", choices=["full"], default=None)
    ap.add_argument("--taylor-hood", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: CUDA, required)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    mcs = not args.taylor_hood
    device = "cpu" if args.cpu else None
    mesh_sizes, orders = grid(args.full == "full", mcs)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rows: list[dict] = []
    cache: dict = {}
    for mesh_size in mesh_sizes:
        for order in orders:
            for gauss_seidel in [True, False]:
                print(f"h={mesh_size} p={order} GS={gauss_seidel}",
                      flush=True)
                iterations, secs = solve(mesh_size, order, gauss_seidel,
                                         cache, mcs, device=device)
                rows.append({"mesh_size": mesh_size, "order": order,
                             "iterations": iterations, "time": secs,
                             "gauss_seidel_enabled": gauss_seidel})
                write_csv(rows, COLUMNS, args.out)
    print("wrote", args.out)
    return rows


if __name__ == "__main__":
    main()

"""2D Navier-Stokes demo on the port -- the templates/NavierStokesSIMPLE_test.py
equivalent: channel with cylinder (maxh 0.05), nu=0.001, order 2, dt=1e-3,
the parabolic inflow of peak 1.5; the initial steady Stokes solve, then
transient steps.

Counterpart of the JAX package's ``scripts/navier_stokes_2d.py``.  The
default model is the Taylor-Hood ``NavierStokes``, as there; ``--mcs``
selects the MCS model ``NavierStokesMCS`` (the reference demo's).  Runs on
the card; ``--device cpu`` for a small check on the CPU.  Writes the
velocity and pressure dof vectors with the mesh to an npz file.

    python -m navier_stokes_tpu_torch.scripts.navier_stokes_2d [--mcs]
        [steps] [maxh] [--device cpu] [--out ns2d_state.npz]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..mesh.generators import channel_with_cylinder_mesh
from ..models import NavierStokes, NavierStokesMCS

H = 0.41


def uin(p):
    """The demo's inflow: parabolic, peak 1.5 at mid-height."""
    out = np.zeros((len(p), 2))
    out[:, 0] = 1.5 * 4 * p[:, 1] * (H - p[:, 1]) / H**2
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=100)
    ap.add_argument("maxh", nargs="?", type=float, default=0.05)
    ap.add_argument("--mcs", action="store_true",
                    help="the MCS model NavierStokesMCS (default: "
                         "Taylor-Hood)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, required)")
    ap.add_argument("--out", default="ns2d_state.npz")
    args = ap.parse_args(argv)

    mesh = channel_with_cylinder_mesh(args.maxh)
    print(f"mesh: {mesh.nv} vertices, {mesh.ne} triangles")
    cls = NavierStokesMCS if args.mcs else NavierStokes
    ns = cls(mesh, nu=0.001, inflow="inlet", outflow="outlet",
             wall="wall|cyl", uin=uin, timestep=1e-3, order=2,
             device=args.device)
    ns.SolveInitial(iterative=True)
    print(f"initial Stokes: {ns.stokes_bpcg_iterations} BPCG iterations, "
          f"{ns.stokes_bpcg_time:.2f}s")
    for i in range(args.steps):
        ns.DoTimeStep()
        if (i + 1) % 20 == 0:
            print(f"step {i + 1}: max|u| = {np.abs(ns.velocity).max():.4f}")
    np.savez(args.out, velocity=ns.velocity, pressure=ns.pressure,
             points=mesh.points, elements=mesh.elements)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Lid-driven cavity Navier-Stokes on the port -- enclosed flow.

Counterpart of the JAX package's ``scripts/navier_stokes_cavity.py``: the
unit square (maxh 0.05), the lid (top) moving with the regularized
u = (16 (x (1-x))^2, 0), no-slip walls, nu=0.01, order 2, dt=2e-3; the
steady Stokes start (BPCG to 1e-8), then transient steps.  No outflow: the
pressure is defined up to a constant, deflated from B, B^T and preM.  The
MCS model by default, ``--taylor-hood`` for the Taylor-Hood one.  Runs on
the card; ``--device cpu`` for a small check on the CPU.

    python -m navier_stokes_tpu_torch.scripts.navier_stokes_cavity
        [--taylor-hood] [steps] [maxh] [--device cpu]
        [--out cavity_state.npz]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..mesh.generators import cavity_mesh
from ..models import NavierStokes, NavierStokesMCS


def lid_velocity(p):
    """Regularized lid: vanishes at the corners (avoids the corner
    singularity of the constant-lid cavity)."""
    out = np.zeros((len(p), 2))
    out[:, 0] = 16.0 * (p[:, 0] * (1.0 - p[:, 0])) ** 2
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=100)
    ap.add_argument("maxh", nargs="?", type=float, default=0.05)
    ap.add_argument("--taylor-hood", action="store_true",
                    help="the Taylor-Hood model (default: MCS)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, required)")
    ap.add_argument("--out", default="cavity_state.npz")
    args = ap.parse_args(argv)

    mesh = cavity_mesh(args.maxh)
    cls = NavierStokes if args.taylor_hood else NavierStokesMCS
    ns = cls(mesh, nu=0.01, inflow="lid", outflow="", wall="wall",
             uin=lid_velocity, timestep=2e-3, order=2, device=args.device)
    ns.SolveInitial(iterative=True, tol=1e-8, maxsteps=100000)
    print(f"initial Stokes: {ns.stokes_bpcg_iterations} BPCG iterations, "
          f"{ns.stokes_bpcg_time:.2f}s")
    for i in range(args.steps):
        ns.DoTimeStep()
        if (i + 1) % 20 == 0:
            print(f"step {i + 1}: max|u dof| = "
                  f"{np.abs(ns.velocity).max():.4f}")
    np.savez(args.out, velocity=ns.velocity, pressure=ns.pressure,
             points=mesh.points, elements=mesh.elements)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

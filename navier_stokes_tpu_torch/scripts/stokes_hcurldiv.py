"""Standalone MCS Stokes on the channel with cylinder -- the reference's
stokes_hcurldiv.py (maxh 0.06, the MCS triple of order 2, parabolic
inflow) on the port.

Counterpart of the JAX package's ``scripts/stokes_hcurldiv.py``: the
sparse direct solve on the host (scipy, the reference's UMFPACK), then the
device path, Jacobi-preconditioned MINRES to 1e-8, with its agreement to
the direct solution.  Runs on the card; ``--device cpu`` for a small check
on the CPU.  Writes the velocity and pressure dofs with the mesh to
``mcs_state.npz``.

    python -m navier_stokes_tpu_torch.scripts.stokes_hcurldiv [maxh]
        [--device cpu] [--out mcs_state.npz]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..mesh.generators import channel_with_cylinder_mesh
from ..models import stokes as st
from ..models.stokes_mcs import (
    assemble_mcs_stokes,
    mcs_discretization,
    solve_mcs_direct,
    solve_mcs_minres,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("maxh", nargs="?", type=float, default=0.06)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, required)")
    ap.add_argument("--out", default="mcs_state.npz")
    args = ap.parse_args(argv)

    mesh = channel_with_cylinder_mesh(args.maxh)
    disc, order = mcs_discretization(2)
    V, S, Q = disc(mesh, velocity_dirichlet="wall|inlet|cyl",
                   velocity_neumann="outlet")
    print(f"mesh h={args.maxh}: ndofs V={V.ndof} S={S.ndof} Q={Q.ndof}")
    system = assemble_mcs_stokes(
        mesh, V, S, Q, st.default_volume_force, st.default_inlet_profile()
    )
    x, t = solve_mcs_direct(system)
    print(f"direct solve: {t:.3f}s")
    x2, res = solve_mcs_minres(system, tol=1e-8, maxsteps=50000,
                               device=args.device)
    print(f"MINRES: {int(res.iterations)} iterations, "
          f"agree to {np.abs(x - x2).max():.2e}")
    o1, o2 = system.offsets
    np.savez(args.out, velocity=x[:o1], pressure=x[o2:],
             points=mesh.points, elements=mesh.elements)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

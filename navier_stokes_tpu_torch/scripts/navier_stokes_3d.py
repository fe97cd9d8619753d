"""3D Navier-Stokes demo on the port -- the templates/NavierStokesSIMPLE_test_3D.py
equivalent: brick channel with a z-axis cylinder, nu=0.001, order 2,
dt=2e-3, inlet profile 16 y (0.41-y) z (0.41-z) / 0.41^4.

Counterpart of the JAX package's ``scripts/navier_stokes_3d.py``.  The
default model is the MCS ``NavierStokesMCS`` (the reference demo's model);
``--hdg`` selects the interior-penalty H(div) model ``NavierStokesHDG3D``,
``--th`` the Taylor-Hood model ``NavierStokes``.  Runs on the card;
``--device cpu`` for a small check on the CPU.

    python -m navier_stokes_tpu_torch.scripts.navier_stokes_3d [--hdg | --th]
        [steps] [maxh] [--device cpu] [--out ns3d_state.npz]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..flagship import uin
from ..mesh.generators import channel_with_cylinder_mesh_3d
from ..models import NavierStokes, NavierStokesHDG3D, NavierStokesMCS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=50)
    ap.add_argument("maxh", nargs="?", type=float, default=0.1)
    ap.add_argument("--hdg", "--hdiv", action="store_true",
                    help="the interior-penalty H(div) model NavierStokesHDG3D")
    ap.add_argument("--th", action="store_true",
                    help="the Taylor-Hood model NavierStokes")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, required)")
    ap.add_argument("--out", default="ns3d_state.npz")
    args = ap.parse_args(argv)
    if args.th and args.hdg:
        ap.error("--th and --hdg exclude each other")

    mesh = channel_with_cylinder_mesh_3d(args.maxh)
    print(f"mesh: {mesh.nv} vertices, {mesh.ne} tets")
    kw = dict(nu=0.001, inflow="inlet", outflow="outlet", wall="wall|cyl",
              uin=uin, timestep=2e-3, order=2, device=args.device)
    if args.hdg:
        ns = NavierStokesHDG3D(mesh, **kw)
        print(f"ndofs: V={ns.Xv.ndof} Q={ns.Q.ndof}")
    elif args.th:
        ns = NavierStokes(mesh, **kw)
        print(f"ndofs: V={ns.V.ndof} Q={ns.Q.ndof}")
    else:
        ns = NavierStokesMCS(mesh, **kw)
        print(f"ndofs: X={ns.n} Q={ns.Q.ndof}")
    ns.SolveInitial(iterative=True)
    print(f"initial Stokes: {ns.stokes_bpcg_iterations} BPCG iterations, "
          f"{ns.stokes_bpcg_time:.2f}s")
    for i in range(args.steps):
        ns.DoTimeStep()
        if (i + 1) % 10 == 0:
            print(f"step {i + 1}: max|u| = {np.abs(ns.velocity).max():.4f}")
    np.savez(args.out, velocity=ns.velocity, pressure=ns.pressure,
             points=mesh.points, elements=mesh.elements)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

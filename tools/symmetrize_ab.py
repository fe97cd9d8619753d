#!/usr/bin/env python3
"""A/B of the port's one deliberate departure from the JAX package's
preconditioner tables: the symmetrization of the stored A_ii^{-1}, S and
edge-star inverses (``build_skeleton_preconditioner_3d(symmetrize=...)``).

For the curved GS configuration (bench.py's default) and the straight
additive one, it builds the flagship solve and runs ``full_solve`` with
the port's symmetrized tables ("on") and with the reference's tables as
computed ("off"), in the order on, off, off, on, and prints each solve's
inner iterations, true f64 residual and seconds, and the card's name and
power limit.

Run from the repository root::

    python3 tools/symmetrize_ab.py                        # GPU, maxh=0.09
    python3 tools/symmetrize_ab.py --device cpu --maxh 0.6
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from navier_stokes_tpu_torch.flagship import (  # noqa: E402
    FlagshipSolve,
    build_model,
)
from navier_stokes_tpu_torch.mesh.generators import (  # noqa: E402
    channel_with_cylinder_mesh_3d,
)
from navier_stokes_tpu_torch.models.auxspace3d import (  # noqa: E402
    build_skeleton_preconditioner_3d,
)


def set_tables(solver: FlagshipSolve, symmetrize: bool) -> None:
    """Rebuild the solve's preA32 with or without the symmetrization (the
    other operators do not depend on it)."""
    m = solver.m
    D = solver.D.cpu().numpy()
    De = D[np.asarray(m.Xv.element_dofs)]
    solver.ops32["preA"] = None  # free the old tables first
    solver.ops32["preA"] = build_skeleton_preconditioner_3d(
        m.Xv, m.A_cond_np * De[:, :, None] * De[:, None, :], m._dirich,
        m.device, torch.float32, coarse_coefficient=m.nu, dof_scale=D,
        gs=solver.gs, split_k=solver.split_k, symmetrize=symmetrize)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--maxh", type=float, default=0.09)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("symmetrize_ab: no CUDA device", file=sys.stderr)
            return 2
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        print(f"[card] {out.stdout.strip()}", flush=True)
    else:
        print(f"[cpu] {torch.get_num_threads()} torch threads", flush=True)
    mesh = channel_with_cylinder_mesh_3d(args.maxh)
    for label, curved, gs in (("curved GS", True, True),
                              ("straight additive", False, False)):
        m = build_model(args.maxh, device=args.device, mesh=mesh,
                        curved=curved)
        solver = FlagshipSolve(m, gs=gs)
        for sym in (True, False, False, True):
            t0 = time.perf_counter()
            set_tables(solver, sym)
            t_build = time.perf_counter() - t0
            res = solver.full_solve()
            print(f"[ab] maxh={args.maxh} {label} symmetrize="
                  f"{'on' if sym else 'off'}: inner={res.inner}, true f64 "
                  f"rel {res.true_rel:.3e}, solve {res.seconds:.3f} s, "
                  f"preA build {t_build:.1f} s", flush=True)
        del solver, m
    return 0


if __name__ == "__main__":
    sys.exit(main())

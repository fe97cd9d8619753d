#!/usr/bin/env python3
"""The 3D model's BPCG initial solve across mesh sizes, and its f32 controls.

For each maxh it builds the channel model (``flagship.build_model``,
curved unless ``--straight``), runs ``SolveInitial(iterative=True,
GS=True, tol=1e-8)`` with the default auxspace preconditioner in f64, and
then the same BPCG iteration (same scaling k, same start, at most twice
the iterations and 50 more) twice more as controls that show what a solve
computed partly in f32 reads: ``f32_preconditioners`` with the outputs of
preA and preM rounded to float32, ``f32_operators`` with those of A, B and
B^T rounded.  Each maxh prints one JSON line: the iteration count, k, the
true f64 relative residual of the saddle system through the plain
operators, and for each control its iteration count, true residual and the
relative velocity difference from the f64 solution.  ``chip_smoke.py``'s
``[bpcg]`` bounds sit between the readings.

Run from the repository root::

    python3 tools/bpcg_study.py --device cpu --maxh 0.6 0.4 0.3
    python3 tools/bpcg_study.py --maxh 0.09          # on the card
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from navier_stokes_tpu_torch.flagship import build_model  # noqa: E402
from navier_stokes_tpu_torch.solvers.bpcg import (  # noqa: E402
    bramble_pasciak_cg_opt,
)

TOL = 1e-8


def rounded_f32(op):
    """``op`` with its output rounded to float32 and widened back."""
    return lambda x: op(x).to(torch.float32).to(torch.float64)


def true_rel(m, f_mod, g_mod, du, p) -> float:
    """||(f - A du - B^T p, g - B du)|| / ||(f, g)|| in f64."""
    r0 = f_mod - m.A(du) - m.BT(p)
    r1 = g_mod - m.B(du)
    num = torch.dot(r0, r0) + torch.dot(r1, r1)
    den = torch.dot(f_mod, f_mod) + torch.dot(g_mod, g_mod)
    return float(torch.sqrt(num / den))


def study(maxh: float, device: str, curved: bool) -> dict:
    t0 = time.perf_counter()
    m = build_model(maxh, device=device, curved=curved)
    pre = m._preA_for(True)
    setup = time.perf_counter() - t0
    res = m.SolveInitial(iterative=True, GS=True, tol=TOL, maxsteps=20000)
    f_mod = torch.where(m.free, m.f - m.A_raw(m.u_bc), 0.0)
    g_mod = -m.B_raw(m.u_bc)
    du, p = res.x
    out = {"maxh": maxh, "curved": curved, "ne": int(m.mesh.ne),
           "ndof": [int(m.n), int(m.Q.ndof)], "setup_s": round(setup, 1),
           "iterations": res.iterations, "converged": res.converged,
           "scale_k": m.stokes_bpcg_scale_k,
           "solve_s": round(m.stokes_bpcg_time, 3),
           "true_rel": true_rel(m, f_mod, g_mod, du, p)}
    ops = (m.A, m.B, m.BT, pre, m.preM)
    for name, rounded in (("f32_preconditioners", (3, 4)),
                          ("f32_operators", (0, 1, 2))):
        ctl = bramble_pasciak_cg_opt(
            *(rounded_f32(op) if i in rounded else op
              for i, op in enumerate(ops)), f_mod, g_mod, tol=TOL,
            maxsteps=2 * res.iterations + 50, scale_k=m.stokes_bpcg_scale_k)
        cu, cp = ctl.x
        out[name] = {
            "iterations": ctl.iterations, "converged": ctl.converged,
            "true_rel": true_rel(m, f_mod, g_mod, cu, cp),
            "velocity_rel": float(torch.linalg.norm(cu - du)
                                  / torch.linalg.norm(m.u))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--maxh", type=float, nargs="+", default=[0.09])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--straight", action="store_true")
    args = ap.parse_args()
    for maxh in args.maxh:
        print(json.dumps(study(maxh, args.device, not args.straight)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The JAX package's BPCG initial solve on the shortened 3D channel.

Runs ``navier_stokes_tpu.models.navier_stokes_mcs.NavierStokesMCS.
SolveInitial(iterative=True, GS=..., tol=1e-8)`` on
``channel_with_cylinder_mesh_3d(maxh, length=1.2, circle_resolution=8)``
(tests/test_navier_stokes_mcs3d.py:_channel3d; nu = 1e-3, dt = 2e-3, order
2, bench.py's inflow) with each A-preconditioner variant asked for, and
prints one JSON object: per variant the iteration count, the
Bramble-Pasciak scaling ``scale_k`` its Lanczos gives (start vector
``jax.random.PRNGKey(0)``) and the seconds of the solve.  ``chip_smoke.py``
holds the port's counts on the card against these, with ``scale_k``
carried across (``BPCG_SMALL_JAX``).

    JAX_PLATFORMS=cpu python3 tools/jax_bpcg_reference.py \\
        [--maxh 0.35] [--variants faceblock:0,faceblock:1,auxspace:1]

A variant is ``preconditioner:GS``.  Runs on the CPU in float64.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 0.41


def uin(p):
    """bench.py's inflow profile."""
    out = np.zeros((len(p), 3))
    out[:, 0] = 16 * p[:, 1] * (H - p[:, 1]) * p[:, 2] * (H - p[:, 2]) / H**4
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--maxh", type=float, default=0.35)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--variants",
                    default="faceblock:0,faceblock:1,auxspace:1")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from navier_stokes_tpu.mesh.generators import (
        channel_with_cylinder_mesh_3d,
    )
    from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
    from navier_stokes_tpu.solvers.bpcg import bp_scale_factor

    mesh = channel_with_cylinder_mesh_3d(args.maxh, length=1.2,
                                         circle_resolution=8)
    cache, models, out = {}, {}, {"maxh": args.maxh, "tol": args.tol,
                                  "ne": int(mesh.ne)}
    for variant in args.variants.split(","):
        pre, gs = variant.split(":")
        gs = bool(int(gs))
        if pre not in models:
            models[pre] = NavierStokesMCS(
                mesh, nu=1e-3, inflow="inlet", outflow="outlet",
                wall="wall|cyl", uin=uin, timestep=2e-3, order=2,
                preconditioner=pre, assembly_cache=cache)
        m = models[pre]
        f_mod = jnp.where(m.free, m.f - m.A_raw(m.u_bc), 0.0)
        k = float(bp_scale_factor(m.A, m._preA_for(gs), f_mod)[0])
        t0 = time.perf_counter()
        res = m.SolveInitial(iterative=True, GS=gs, tol=args.tol,
                             maxsteps=20000)
        secs = time.perf_counter() - t0
        out[variant] = {"iterations": int(res.iterations),
                        "converged": bool(res.converged), "scale_k": k,
                        "seconds": round(secs, 1)}
        print(f"{variant}: {out[variant]}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

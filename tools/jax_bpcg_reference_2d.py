"""The JAX package's BPCG initial solve of the 2D demo configuration.

Builds ``navier_stokes_tpu.models.navier_stokes_mcs.NavierStokesMCS`` on
``channel_with_cylinder_mesh(maxh)`` at the demo's settings
(scripts/navier_stokes_2d.py: nu = 1e-3, dt = 1e-3, order 2, the parabolic
inflow of peak 1.5, the auxspace A-preconditioner), runs
``SolveInitial(iterative=True)`` (multicolor GS, tol 1e-10) and prints one
JSON object: the mesh and dof counts, the iteration count, the
Bramble-Pasciak scaling ``scale_k`` its Lanczos gives (start vector
``jax.random.PRNGKey(0)``) and the seconds of the build and of the solve.
``--th`` adds the Taylor-Hood model's ``SolveInitial`` count and k on the
same mesh.  ``chip_smoke.py`` ``[mcs2d]`` holds the port's count on the card to
the MCS count with ``scale_k`` carried across (``MCS2D_JAX``).

    JAX_PLATFORMS=cpu python3 tools/jax_bpcg_reference_2d.py \\
        [--maxh 0.05] [--th]

Runs on the CPU in float64.
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
    """scripts/navier_stokes_2d.py's inflow profile."""
    out = np.zeros((len(p), 2))
    out[:, 0] = 1.5 * 4 * p[:, 1] * (H - p[:, 1]) / H**2
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--maxh", type=float, default=0.05)
    ap.add_argument("--th", action="store_true",
                    help="also the Taylor-Hood model's initial solve")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from navier_stokes_tpu.mesh.generators import channel_with_cylinder_mesh
    from navier_stokes_tpu.models.navier_stokes import NavierStokes
    from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
    from navier_stokes_tpu.solvers.bpcg import bp_scale_factor

    mesh = channel_with_cylinder_mesh(args.maxh)
    kw = dict(nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
              uin=uin, timestep=1e-3, order=2)
    t0 = time.perf_counter()
    m = NavierStokesMCS(mesh, **kw)
    build = time.perf_counter() - t0
    f_mod = jnp.where(m.free, m.f - m.A_raw(m.u_bc), 0.0)
    k = float(bp_scale_factor(m.A, m._preA_for(True), f_mod)[0])
    t0 = time.perf_counter()
    res = m.SolveInitial(iterative=True)
    secs = time.perf_counter() - t0
    out = {"maxh": args.maxh, "ne": int(mesh.ne), "ndof_u": int(m.n),
           "ndof_p": int(m.Q.ndof), "iterations": int(res.iterations),
           "converged": bool(res.converged), "scale_k": k,
           "build_seconds": round(build, 1), "solve_seconds": round(secs, 1)}
    if args.th:
        t0 = time.perf_counter()
        th = NavierStokes(mesh, **kw)
        f_th = jnp.where(th.free_s[None], th.f - th._stokesA_raw(th.u_bc),
                         0.0).reshape(-1)
        k_th = float(bp_scale_factor(th.A, th.preA, f_th)[0])
        res = th.SolveInitial(iterative=True)
        out["th"] = {"iterations": int(res.iterations),
                     "converged": bool(res.converged), "scale_k": k_th,
                     "seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""The JAX package's numbers for chip_smoke.py's ``[sweep]`` and
``[ns-sweep]`` phases.

``--parts sweep``: the 3D MCS Reynolds-number ensemble of
``navier_stokes_tpu.parallel.sweep.run_reynolds_ensemble_mcs`` on the
straight ``channel_with_cylinder_mesh_3d(0.35)`` (order 2, nu = 1e-3, dt =
2e-3, the peak-1 inflow of tests/test_sweep_checkpoint.py), 8 viscosities
geomspace(1e-3, 1e-2), 2 steps from u = u_bc, without a device mesh.  The
model's Chebyshev bounds come from the JAX Lanczos (start vector
``jax.random.PRNGKey(0)``, 30 steps, as the model takes them) and are
printed, so that the port can take the same.  Per member: max |u|,
||u_i - u_0||, ||u_i - u_bc|| and the M* and projection CG counts of each
step (recorded by ``jax.debug.callback`` on the vmapped run).
``--mstar-tol`` replaces the step's M* CG tolerance (the reference's 1e-4)
for a run whose states do not hang on where that CG stops.

``--parts ns-sweep``: ``scripts/run_ns_sweep.py``'s default subset (the 2D
MCS model, h = 2^-3..2^-1 x order 3, 2 x GS on / off), each solve's BPCG
count and the Bramble-Pasciak k of its Lanczos.

``--parts bases``: the JAX package's element-interior BDM_2 basis functions
on the tetrahedron (``fem/hdiv3d.bdm_tet``'s SVD null space of the face
moments, coefficient rows in the modal frame) for all 24 face-orientation
combos, written to ``--bases-out``: chip_smoke.py carries them into the
port's model of the JAX comparison.  That null space is six-dimensional
and its orthonormal basis is not unique, so another host's LAPACK may
return another rotation of it, and the states' dof vectors (and the
Jacobi-preconditioned solves of the step) would then differ from JAX's.

Prints one JSON object per part.  Runs on the CPU in float64:

    JAX_PLATFORMS=cpu python3 tools/jax_sweep_reference.py \\
        [--parts sweep,ns-sweep,bases] [--maxh 0.35] [--mstar-tol 1e-10]
        [--bases-out tools/jax_bdm2_cell_bases.npz]
"""

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_MAXH, SWEEP_MEMBERS, SWEEP_STEPS = 0.35, 8, 2


def uin3(p):
    """tests/test_sweep_checkpoint.py's 3D inflow (peak 1)."""
    H = 0.41
    out = np.zeros((len(p), 3))
    out[:, 0] = 16 * p[:, 1] * (H - p[:, 1]) * p[:, 2] * (H - p[:, 2]) / H**4
    return out


def sweep_part(maxh=SWEEP_MAXH, mstar_tol=None):
    import jax
    import jax.numpy as jnp

    from navier_stokes_tpu.linalg.lanczos import lanczos_eigenvalues
    from navier_stokes_tpu.mesh.generators import (
        channel_with_cylinder_mesh_3d,
    )
    from navier_stokes_tpu.models import navier_stokes_mcs as mcs_mod
    from navier_stokes_tpu.parallel import sweep
    from navier_stokes_tpu.precond.chebyshev import chebyshev_preconditioner

    t0 = time.perf_counter()
    m = mcs_mod.NavierStokesMCS(
        channel_with_cylinder_mesh_3d(maxh), nu=1e-3, inflow="inlet",
        outflow="outlet", wall="wall|cyl", uin=uin3, timestep=2e-3,
        order=2)
    build = time.perf_counter() - t0
    lams = lanczos_eigenvalues(m._Mv, m._preMv, m.u_bc, 30)
    beta = 1.05 * float(jnp.max(lams))
    bounds = (0.02 * beta, beta)
    m._mass_cheb = chebyshev_preconditioner(m._Mv, m._preMv, m.u_bc,
                                            degree=16, bounds=bounds)

    # each CG count is recorded with its member's viscosity: the vmapped
    # callbacks of one step arrive in no fixed member order
    counts = {"mstar": [], "project": []}
    current = {}

    def recording(cg, kind):
        def wrapped(*a, **k):
            if kind == "mstar" and mstar_tol is not None:
                k["tol"] = mstar_tol
            res = cg(*a, **k)
            jax.debug.callback(
                lambda it, nu: counts[kind].append((float(nu), int(it))),
                res.iterations, current["nu"])
            return res

        return wrapped

    def keyed(make_step):
        def make(model):
            step = make_step(model)

            def stepped(u, nu):
                current["nu"] = nu
                return step(u, nu)

            return stepped

        return make

    sweep.cg = recording(sweep.cg, "mstar")
    mcs_mod.cg = recording(mcs_mod.cg, "project")
    sweep.make_viscosity_step_mcs = keyed(sweep.make_viscosity_step_mcs)
    nus = np.geomspace(1e-3, 1e-2, SWEEP_MEMBERS)
    t0 = time.perf_counter()
    out = np.asarray(sweep.run_reynolds_ensemble_mcs(m, nus, SWEEP_STEPS))
    secs = time.perf_counter() - t0
    u_bc = np.asarray(m.u_bc)
    members = []
    for i in range(SWEEP_MEMBERS):
        members.append({
            "nu": float(nus[i]),
            "max_abs_u": float(np.abs(out[i]).max()),
            "dist_u0": float(np.linalg.norm(out[i] - out[0])),
            "dist_u_bc": float(np.linalg.norm(out[i] - u_bc)),
            **{kind: [it for nu, it in c if nu == float(nus[i])]
               for kind, c in counts.items()}})
        assert all(len(members[-1][k]) == SWEEP_STEPS for k in counts)
    return {"maxh": maxh, "mstar_tol": mstar_tol or 1e-4,
            "ndof": int(m.n), "ne": int(m.mesh.ne),
            "cheb_bounds": list(bounds), "steps": SWEEP_STEPS,
            "members": members, "build_seconds": round(build, 1),
            "ensemble_seconds": round(secs, 1)}


def ns_sweep_part():
    import jax.numpy as jnp

    from navier_stokes_tpu.solvers.bpcg import bp_scale_factor

    spec = importlib.util.spec_from_file_location(
        "jax_run_ns_sweep", os.path.join(ROOT, "scripts", "run_ns_sweep.py"))
    jr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jr)
    rows, cache = [], {}
    for h in [2.0**-e for e in (3, 2, 1)]:
        for order in (3, 2):
            for gs in (True, False):
                n, secs = jr.solve(h, order, gs, cache, True)
                m = cache[(h, order)]
                f_mod = jnp.where(m.free, m.f - m.A_raw(m.u_bc), 0.0)
                k = float(bp_scale_factor(m.A, m._preA_for(gs), f_mod)[0])
                rows.append({"mesh_size": h, "order": order,
                             "gauss_seidel_enabled": gs, "iterations": n,
                             "scale_k": k, "time": round(secs, 2)})
                print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return {"rows": rows}


def bases_part(out):
    import itertools

    from navier_stokes_tpu.fem.hdiv3d import TET_FACES, bdm_tet

    combos, cells = [], []
    for ranks in itertools.permutations(range(4)):
        els = np.array(ranks)
        combo = tuple(tuple(int(p) for p in np.argsort(els[list(fv)]))
                      for fv in TET_FACES)
        b = bdm_tet(2, combo)
        combos.append(combo)
        cells.append(b.coeffs[b.n_basis - b.n_cell:])
    np.savez(out, order=2, combos=np.array(combos, np.int64),
             cells=np.stack(cells))
    return {"path": os.path.relpath(out, ROOT), "combos": len(combos),
            "cells_shape": list(np.stack(cells).shape),
            "numpy": np.__version__}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="sweep,ns-sweep")
    ap.add_argument("--maxh", type=float, default=SWEEP_MAXH,
                    help="the sweep part's mesh size")
    ap.add_argument("--bases-out", default=os.path.join(
        ROOT, "tools", "jax_bdm2_cell_bases.npz"))
    ap.add_argument("--mstar-tol", type=float, default=None,
                    help="the sweep part's M* CG tolerance (default: the "
                    "step's own 1e-4)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_enable_x64", True)
    for part in args.parts.split(","):
        if part == "sweep":
            out = sweep_part(args.maxh, args.mstar_tol)
        elif part == "ns-sweep":
            out = ns_sweep_part()
        elif part == "bases":
            out = bases_part(args.bases_out)
        else:
            raise ValueError(f"unknown part {part!r}")
        print(json.dumps({part: out}), flush=True)


if __name__ == "__main__":
    main()

"""The JAX package's counts on the Stokes catalog and its heat errors.

Runs, on the CPU in float64, what ``chip_smoke.py``'s ``[stokes]`` and
``[heat]`` phases hold the port to, and prints one JSON object per part:

* ``hdg``: the active configuration of scripts/run_stokes.py -- "HDG BDM 2"
  (alpha 10, edgeblock A-preconditioner) on the order-3 curved cylinder,
  Bramble-Pasciak CG to 1e-7 (at most 10,000 steps) -- at each ``--maxh``
  (default 0.1 and 0.01): dofs, the BPCG count, the Bramble-Pasciak
  scaling k its Lanczos gives (start vector ``jax.random.PRNGKey(0)``),
  the true relative residual of the saddle system at the solution and the
  error history at iterations 10, 20 and 30;
* ``mixed``: the mixed pairs at maxh 0.1 with the Jacobi A-preconditioner
  (TH2, TH3, mini, P2-P0, P1nc-P0, P2+-P1), BPCG to 1e-7 (the same
  figures), and TH2 with block-preconditioned MINRES to 1e-7 (count, true
  residual);
* ``mcs``: scripts/stokes_hcurldiv.py at maxh 0.06 -- the MCS triple of
  order 2, the direct solve, then MINRES to 1e-8 (at most 50,000 steps):
  the count, whether it converged and its largest difference from the
  direct solution;
* ``heat``: ``HeatEquation`` at the reference's literals (maxh 0.1,
  order 10, 10 Gauss stages, subspace 5, inner CG to 1e-13), the L2
  errors of the convergence study at the time steps 10^(-k/2),
  k = 2..``--heat-steps`` + 1, end time 0.05.

    JAX_PLATFORMS=cpu python3 tools/jax_stokes_reference.py \\
        [--parts hdg,mixed,mcs,heat] [--maxh 0.1,0.01] [--heat-steps 5]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MIXED = ("taylor hood 2", "taylor hood 3", "mini", "P2, P0", "P1nc, P0",
         "P2+, P1")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="hdg,mixed,mcs,heat")
    ap.add_argument("--maxh", default="0.1,0.01",
                    help="the HDG part's mesh sizes")
    ap.add_argument("--heat-steps", type=int, default=5)
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_enable_x64", True)

    from navier_stokes_tpu.mesh.curved import curve_to_circle
    from navier_stokes_tpu.mesh.generators import channel_with_cylinder_mesh
    from navier_stokes_tpu.models import discretizations as disc
    from navier_stokes_tpu.models import stokes as st
    from navier_stokes_tpu.models.stokes_hybrid import (
        build_hybrid_stokes_system,
    )
    from navier_stokes_tpu.models.stokes_mcs import (
        assemble_mcs_stokes,
        mcs_discretization,
        solve_mcs_direct,
        solve_mcs_minres,
    )
    from navier_stokes_tpu.solvers.bpcg import bp_scale_factor

    def true_rel(system, u, p):
        """||r|| / ||(f, g)|| of the saddle system at (u - u_bc, p)."""
        du = u - system.u_bc
        r0 = system.f - system.A(du) - system.BT(p)
        r1 = system.g - system.B(du)
        num = float(np.sqrt(np.sum(r0**2) + np.sum(r1**2)))
        return num / float(np.sqrt(np.sum(system.f**2)
                                   + np.sum(system.g**2)))

    def bpcg(system):
        k = float(bp_scale_factor(system.A, system.preA, system.f)[0])
        t0 = time.perf_counter()
        u, p, errors, _, _ = st.solve_with_bramble_pasciak_cg(
            system, tolerance=1e-7, max_steps=10000)
        # the error history holds the start and one entry per iteration
        return {"iterations": len(errors) - 1, "scale_k": k,
                "true_rel": true_rel(system, u, p),
                "errors_at": {i: errors[i] for i in (10, 20, 30)},
                "solve_seconds": round(time.perf_counter() - t0, 1)}

    if "hdg" in parts:
        for maxh in (float(h) for h in args.maxh.split(",")):
            mesh = channel_with_cylinder_mesh(maxh)
            t0 = time.perf_counter()
            system = build_hybrid_stokes_system(
                mesh, disc.bdm_hybrid(2, 10)[0],
                uin=st.default_inlet_profile(),
                geometry=curve_to_circle(mesh, "cyl", (0.2, 0.2), 0.05, 3))
            out = {"part": "hdg", "maxh": maxh, "ne": int(mesh.ne),
                   "ndof_u": int(system.V.ndof), "ndof_p": int(system.Q.ndof),
                   "build_seconds": round(time.perf_counter() - t0, 1)}
            out.update(bpcg(system))
            print(json.dumps(out), flush=True)

    if "mixed" in parts:
        mesh = channel_with_cylinder_mesh(0.1)
        catalog = {
            "taylor hood 2": disc.taylor_hood(2),
            "taylor hood 3": disc.taylor_hood(3),
            "mini": disc.mini(),
            "P2, P0": disc.P2_velocity_constant_pressure(),
            "P1nc, P0": disc.P1_nonconforming_velocity_constant_pressure(),
            "P2+, P1": disc.P2_velocity_with_cubic_bubbles_linear_pressure(),
        }
        for name in MIXED:
            system = st.build_stokes_system(
                mesh, catalog[name][0], uin=st.default_inlet_profile())
            out = {"part": "mixed", "name": name, "maxh": 0.1,
                   "ndof_u": int(system.V.ndof), "ndof_p": int(system.Q.ndof)}
            out.update(bpcg(system))
            print(json.dumps(out), flush=True)
        system = st.build_stokes_system(
            mesh, catalog["taylor hood 2"][0], uin=st.default_inlet_profile())
        u, p, errors, _, _ = st.solve_with_min_res(system, tolerance=1e-7,
                                                   max_steps=10000)
        print(json.dumps({"part": "mixed", "name": "taylor hood 2 minres",
                          "maxh": 0.1, "iterations": len(errors) - 1,
                          "true_rel": true_rel(system, u, p)}), flush=True)

    if "mcs" in parts:
        mesh = channel_with_cylinder_mesh(0.06)
        V, S, Q = mcs_discretization(2)[0](
            mesh, velocity_dirichlet="wall|inlet|cyl",
            velocity_neumann="outlet")
        system = assemble_mcs_stokes(mesh, V, S, Q, st.default_volume_force,
                                     st.default_inlet_profile())
        x, _ = solve_mcs_direct(system)
        t0 = time.perf_counter()
        x2, res = solve_mcs_minres(system, tol=1e-8, maxsteps=50000)
        print(json.dumps({
            "part": "mcs", "maxh": 0.06, "ne": int(mesh.ne),
            "ndofs": int(system.ndofs), "iterations": int(res.iterations),
            "converged": bool(res.converged),
            "final_error": float(res.errors[int(res.iterations)]),
            "max_diff_direct": float(np.abs(x - x2).max()),
            "solve_seconds": round(time.perf_counter() - t0, 1)}),
            flush=True)

    if "heat" in parts:
        from navier_stokes_tpu.models.heat import (
            DEFAULT_KL,
            HeatEquation,
            exact_solution,
            sum_of_unit_square_laplace_eigenfunctions,
        )

        steps = np.logspace(-1, -4, num=7).tolist()[:args.heat_steps]
        t0 = time.perf_counter()
        model = HeatEquation(maxh=0.1, order=10)
        initial = sum_of_unit_square_laplace_eigenfunctions(DEFAULT_KL)
        errors = []
        for ts in steps:
            T, final_time = model.solve(initial, 0.05, ts)
            errors.append(model.l2_error(T, exact_solution(DEFAULT_KL,
                                                           final_time)))
        print(json.dumps({"part": "heat", "maxh": 0.1, "order": 10,
                          "ndof": int(model.ndof), "time_steps": steps,
                          "errors": errors,
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)


if __name__ == "__main__":
    main()

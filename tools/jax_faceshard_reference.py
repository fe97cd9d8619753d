"""The JAX package's sharded solves on virtual CPU devices.

Runs ``navier_stokes_tpu.parallel`` on virtual CPU devices
(``--xla_force_host_platform_device_count``: 2 for ``face`` and ``dd``,
the world sizes asked for ``graft`` and ``dd3d``) in float64 and prints
one JSON object per solve:

* ``face``: ``faceshard.sharded_fast_flagship_solve`` on the straight 3D
  channel with cylinder (tests/test_faceshard.py's model: order 2, nu 1e-3,
  dt 2e-3, the faceblock preconditioner) with the multicolor GS sweep, in
  four runs (``--face-runs``): ``cpu-test`` at maxh 0.6, tol and
  inner_tol 1e-2, ``two_phase=False`` (tests/test_torch_faceshard_solve.py;
  ``--save`` writes its solution to ``tools/jax_faceshard_x.npz``, float32,
  for that test); ``parity`` at maxh 0.6 as tests/test_faceshard.py's
  parity solve runs it (``two_phase=False``, tol 1e-6, inner_tol 5e-7);
  ``card`` the same settings at maxh 0.35 (``chip_smoke.py`` ``[shard]``'s
  two ranks); ``dryrun`` at maxh 0.35 as
  ``__graft_entry__.dryrun_multichip`` runs it (2-phase, tol 1e-8,
  inner_tol 5e-7) -- the inner iterations, passes, relative residual,
  halo and owned face rows, and seconds;
* ``dd``: ``ddshard.sharded_flagship_solve`` on the 2D channel at maxh
  0.3 with the vertexstar preconditioner (tests/test_parallel.py's model,
  tol 1e-9), with the Bramble-Pasciak ``scale_k`` its Lanczos gives on the
  sharded vectors (start vector ``jax.random.PRNGKey(0)``);
* ``graft``: the ``dryrun`` run (``__graft_entry__.dryrun_multichip``'s
  spatial half) at each world size of ``--graft-shards`` (default 1, the
  one-card machine's; 4 for a four-card one);
* ``dd3d``: tests/test_parallel.py's 3D dd case -- the straight 3D
  channel at maxh 0.35 with the faceblock preconditioner, the model's
  ``SolveInitial(iterative=True, GS=False, tol=1e-8, maxsteps=6000)`` and
  ``ddshard.sharded_flagship_solve`` to 1e-8 at each world size of
  ``--dd3d-shards`` (default 1): BPCG counts, the sharded solve's
  Bramble-Pasciak k, the sharded velocity's distance from the single solve over max
  |u|, and seconds.

``chip_smoke.py`` ``[shard]``, ``[graft]`` and ``[dd3d]`` hold the port's
counts on the card to these (``SHARD_JAX``, ``GRAFT_JAX``, ``DD3D_JAX``),
and PERF.md records them.

    JAX_PLATFORMS=cpu python3 tools/jax_faceshard_reference.py \\
        [--parts face,dd,graft,dd3d]
        [--face-runs cpu-test,parity,card,dryrun] [--save]
        [--graft-shards 1,4] [--dd3d-shards 1]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 0.41
SHARDS = 2
# run -> (maxh, the solve's settings)
FACE_RUNS = {
    "cpu-test": (0.6, dict(tol=1e-2, inner_tol=1e-2, inner_maxsteps=800,
                           gs=True, two_phase=False)),
    "parity": (0.6, dict(tol=1e-6, inner_tol=5e-7, inner_maxsteps=800,
                         gs=True, two_phase=False)),
    "card": (0.35, dict(tol=1e-6, inner_tol=5e-7, inner_maxsteps=800,
                        gs=True, two_phase=False)),
    "dryrun": (0.35, dict(tol=1e-8, inner_tol=5e-7, inner_maxsteps=800,
                          gs=True, two_phase=True)),
}
SOLUTION = os.path.join(ROOT, "tools", "jax_faceshard_x.npz")
DD_MAXH, DD_TOL, DD_MAXSTEPS = 0.3, 1e-9, 3000
DD3D_MAXH, DD3D_TOL, DD3D_MAXSTEPS = 0.35, 1e-8, 6000


def uin3(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = 16 * p[:, 1] * (H - p[:, 1]) * p[:, 2] * (H - p[:, 2]) / H**4
    return out


def uin2(p):
    return np.stack([1.5 * 4 * p[:, 1] * (H - p[:, 1]) / H**2,
                     np.zeros(len(p))], 1)


def face_part(run, save=False, shards=SHARDS):
    from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
    from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
    from navier_stokes_tpu.parallel.faceshard import (
        sharded_fast_flagship_solve,
    )
    from navier_stokes_tpu.parallel.sharding import device_mesh

    maxh, kw = FACE_RUNS[run]
    t0 = time.perf_counter()
    ns = NavierStokesMCS(
        channel_with_cylinder_mesh_3d(maxh), nu=1e-3, inflow="inlet",
        outflow="outlet", wall="wall|cyl", uin=uin3, timestep=2e-3, order=2,
        preconditioner="faceblock")
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    (xu, xp), rel, passes, inner, plan = sharded_fast_flagship_solve(
        ns, device_mesh(shards), **kw)
    t_solve = time.perf_counter() - t0
    if save:
        np.savez_compressed(SOLUTION, x_u=xu.astype(np.float32),
                            x_p=xp.astype(np.float32))
    return dict(part="face", run=run, maxh=maxh, shards=shards,
                ne=ns.mesh.ne, nface=ns.mesh.nface, n=ns.n, np=ns.Q.ndof, **kw,
                inner=int(inner), passes=passes, rel=float(rel),
                halo_rows=[len(h) for h in plan.halo_faces],
                own_rows=[len(o) for o in plan.own_faces],
                build_seconds=t_build, solve_seconds=t_solve)


def dd_part():
    from navier_stokes_tpu.mesh.generators import channel_with_cylinder_mesh
    from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
    from navier_stokes_tpu.parallel.ddshard import sharded_flagship_solve
    from navier_stokes_tpu.parallel.sharding import device_mesh
    from navier_stokes_tpu.solvers import bpcg

    ns = NavierStokesMCS(
        channel_with_cylinder_mesh(DD_MAXH), nu=1e-3, inflow="inlet",
        outflow="outlet", wall="wall|cyl", uin=uin2, timestep=1e-3, order=2,
        preconditioner="vertexstar")
    ks = []
    own = bpcg.bp_scale_factor

    def recording(*a, **k):
        out = own(*a, **k)
        ks.append(float(out[0]))
        return out

    bpcg.bp_scale_factor = recording
    try:
        t0 = time.perf_counter()
        res, pu, pp = sharded_flagship_solve(ns, device_mesh(SHARDS),
                                             tol=DD_TOL, maxsteps=DD_MAXSTEPS)
        t_solve = time.perf_counter() - t0
    finally:
        bpcg.bp_scale_factor = own
    return dict(part="dd", maxh=DD_MAXH, shards=SHARDS, ne=ns.mesh.ne,
                n=ns.n, np=ns.Q.ndof, tol=DD_TOL,
                iterations=int(res.iterations),
                converged=bool(res.converged), scale_k=ks[0],
                npad_u=int(pu.npad), npad_p=int(pp.npad),
                solve_seconds=t_solve)


def dd3d_part(shards):
    from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
    from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
    from navier_stokes_tpu.parallel.ddshard import sharded_flagship_solve
    from navier_stokes_tpu.parallel.sharding import device_mesh
    from navier_stokes_tpu.solvers import bpcg

    def model():
        return NavierStokesMCS(
            channel_with_cylinder_mesh_3d(DD3D_MAXH), nu=1e-3,
            inflow="inlet", outflow="outlet", wall="wall|cyl", uin=uin3,
            timestep=2e-3, order=2, preconditioner="faceblock")

    ks = []
    own = bpcg.bp_scale_factor

    def recording(*a, **k):
        out = own(*a, **k)
        ks.append(float(out[0]))
        return out

    # the model's SolveInitial takes its k inside a jit (not recorded)
    single = model()
    t0 = time.perf_counter()
    single.SolveInitial(iterative=True, GS=False, tol=DD3D_TOL,
                        maxsteps=DD3D_MAXSTEPS)
    t_single = time.perf_counter() - t0
    u = np.asarray(single.u)
    out = [dict(part="dd3d", run="single", maxh=DD3D_MAXH,
                ne=single.mesh.ne, n=single.n, np=single.Q.ndof,
                tol=DD3D_TOL, iterations=int(single.stokes_bpcg_iterations),
                solve_seconds=t_single)]
    bpcg.bp_scale_factor = recording
    try:
        for s in shards:
            ns = model()
            t0 = time.perf_counter()
            res, pu, _ = sharded_flagship_solve(
                ns, device_mesh(s), tol=DD3D_TOL, maxsteps=DD3D_MAXSTEPS)
            t_solve = time.perf_counter() - t0
            u_sh = pu.to_global(np.asarray(res.x[0])) + np.asarray(ns.u_bc)
            out.append(dict(part="dd3d", run="sharded", shards=s,
                            maxh=DD3D_MAXH, tol=DD3D_TOL,
                            iterations=int(res.iterations),
                            converged=bool(res.converged), scale_k=ks[-1],
                            diff_over_max_u=float(np.abs(u_sh - u).max()
                                                  / np.abs(u).max()),
                            solve_seconds=t_solve))
    finally:
        bpcg.bp_scale_factor = own
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="face,dd")
    ap.add_argument("--face-runs", default="cpu-test,parity,card,dryrun")
    ap.add_argument("--save", action="store_true",
                    help="write the cpu-test run's solution")
    ap.add_argument("--graft-shards", default="1")
    ap.add_argument("--dd3d-shards", default="1")
    args = ap.parse_args(argv)
    graft = [int(s) for s in args.graft_shards.split(",")]
    dd3d = [int(s) for s in args.dd3d_shards.split(",")]
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count="
            f"{max([SHARDS] + graft + dd3d)}")
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    parts = args.parts.split(",")
    if "face" in parts:
        for run in args.face_runs.split(","):
            print(json.dumps(face_part(
                run, args.save and run == "cpu-test")), flush=True)
    if "dd" in parts:
        print(json.dumps(dd_part()), flush=True)
    if "graft" in parts:
        for n in graft:
            print(json.dumps(face_part("dryrun", shards=n)), flush=True)
    if "dd3d" in parts:
        for line in dd3d_part(dd3d):
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

"""Configuration ``hdg3d-cyl-h0.09``: the 3D HDG model of the DFG channel
with a straight cylinder (see the JSON file beside this one).

The program is driven through its public API only: the mesh generator and
``NavierStokesHDG3D`` with chip_smoke's ``[hdg3d]`` arguments and the
inflow scaled by Um.  One op, ``stokes_solve``: each unit of the window is
one ``SolveInitial(iterative=True, GS=True, tol)``, which starts from the
boundary data; nothing of one solve is handed to the next.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import draw_um, wrap_span

INFLOW, OUTFLOW, WALL = "inlet", "outlet", "wall|cyl"
DIRICHLET = INFLOW + "|" + WALL
LANCZOS_STEPS = 40  # the Bramble-Pasciak scaling's Lanczos, per solve


class System:
    """The program's objects for one run of ``stokes_solve``."""

    def __init__(self, spec: dict, seed: int, traffic: dict, device, parts):
        from navier_stokes_tpu_torch.flagship import uin
        from navier_stokes_tpu_torch.mesh.generators import (
            channel_with_cylinder_mesh_3d,
        )
        from navier_stokes_tpu_torch.models import NavierStokesHDG3D

        self.op = traffic["op"]
        if self.op != "stokes_solve":
            raise ValueError(f"unknown op {self.op!r}")
        self.tol = traffic["params"]["tol"]
        self.um = um = draw_um(spec, seed)

        def inflow(p):
            return um * uin(p)

        with parts("mesh"):
            mesh = channel_with_cylinder_mesh_3d(spec["maxh"])
        with parts("model"):
            self.m = NavierStokesHDG3D(
                mesh, nu=spec["nu"], inflow=INFLOW, outflow=OUTFLOW,
                wall=WALL, uin=inflow, timestep=spec["dt"],
                order=spec["order"], alpha=spec["alpha"], device=device)
        parts.add({f"model: {k}": v for k, v in self.m.setup_seconds.items()})
        with parts("warm-up (scaling and two iterations)"):
            self.m.SolveInitial(iterative=True, GS=True, tol=self.tol,
                                maxsteps=2)
        self.solutions = []

    def run_unit(self) -> dict:
        m = self.m
        res = m.SolveInitial(iterative=True, GS=True, tol=self.tol)
        self.solutions.append((m.u, m.p))
        return {"its": int(m.stokes_bpcg_iterations),
                "failed": not res.converged}

    def add_spans(self, span):
        wrap_span(self.m, "preA", span)
        wrap_span(self.m, "A", span)

    def release(self, rng) -> dict:
        out = {"um": self.um, "solutions": [
            (u.cpu().numpy(), p.cpu().numpy()) for u, p in self.solutions]}
        self.__dict__.clear()
        return out


# -- the yardstick ----------------------------------------------------------


def check(spec: dict, material: dict, device, log=print) -> list:
    """The true relative residual of every solve of the window, through the
    reference's own assembly: (name, widest value, limit)."""
    return [(name, value, spec["limits"][name]) for name, value, _ in
            _readings(spec, material, device, log, control=False)]


def control(spec: dict, material: dict, device, log=print) -> list:
    """(name, the program's reading, the control's reading): the control is
    each solve's f64 state rounded to f32, the best an answer held in the
    precision below the configuration's float64 can read."""
    return _readings(spec, material, device, log, control=True)


def _readings(spec, material, device, log, control):
    import time

    from perfbench.reference.systems import StokesReference, hdg3d_host

    t0 = time.perf_counter()
    host = hdg3d_host(spec["maxh"], spec["order"], spec["nu"], spec["alpha"])
    ref = StokesReference(host, material["um"], torch.float64, device)
    log(f"[reference] host tables {time.perf_counter() - t0:.1f} s")
    sols = material["solutions"]
    rels = [ref.true_rel(u, p) for u, p in sols]
    log("[reference] true relative residual per solve "
        + " ".join(f"{r:.4e}" for r in rels))
    ctl = None
    if control:
        ctl = max((ref.true_rel(np.float32(u).astype(np.float64),
                                np.float32(p).astype(np.float64))
                   for u, p in sols), default=None)
    return [("stokes_rel", max(rels, default=float("inf")), ctl)]


def sizes(spec: dict) -> dict:
    """The sizes the byte counts need, from the reference's mesh and
    spaces."""
    from perfbench.reference.assembly import (
        HDiv3D,
        HybridVelocitySpace3D,
        VectorFacet3D,
    )
    from perfbench.reference.fem.spaces import H1, L2
    from perfbench.reference.mesh.generators import (
        channel_with_cylinder_mesh_3d,
    )
    from perfbench.reference.systems import star_widths

    mesh = channel_with_cylinder_mesh_3d(spec["maxh"])
    k = spec["order"]
    Xv = HybridVelocitySpace3D(HDiv3D(mesh, k, dirichlet=DIRICHLET),
                               VectorFacet3D(mesh, k, dirichlet=DIRICHLET))
    Q = L2(mesh, k - 1)
    coarse = H1(mesh, 1, dirichlet=DIRICHLET)
    w = star_widths({"Xv": Xv})
    return {"ne": mesh.ne, "nv": mesh.nv, "n": Xv.ndof, "nq": Q.ndof,
            "nb": Xv.element_dofs.shape[1], "mq": Q.basis.n_basis,
            "star_entries": int(np.sum(w.astype(np.int64) ** 2)),
            "star_dofs": int(w.sum()), "stars": len(w),
            "coarse_free": int(coarse.free_mask.sum())}


def table_bytes(spec: dict, op: str, counts: dict, sz: dict) -> int:
    """Bytes one solve of k BPCG iterations needs (f64): every table byte
    read once per apply, the input vector read and the output written once
    per apply.  Applies per solve, from the algorithm (SolveInitial,
    bp_scale_factor, BPCG v2): A k + 46 (one per iteration and the loop's
    extra pass, LANCZOS_STEPS in the scaling, five around the start);
    the A-preconditioner k + 45 (the vertex stars at their real widths, no
    padding, and the dense P1 coarse inverse on its three columns); B or
    B^T 2k + 8."""
    k = counts["its"]
    ne, nb, mq, n, nq = sz["ne"], sz["nb"], sz["mq"], sz["n"], sz["nq"]
    applies = {
        "A": (k + 6 + LANCZOS_STEPS, ne * nb * nb + 2 * n),
        "preA": (k + 5 + LANCZOS_STEPS,
                 sz["star_entries"] + 2 * sz["star_dofs"]
                 + sz["coarse_free"] ** 2 + 6 * sz["nv"]),
        "B": (2 * k + 8, ne * mq * nb + n + nq),
    }
    return 8 * sum(c * per for c, per in applies.values())

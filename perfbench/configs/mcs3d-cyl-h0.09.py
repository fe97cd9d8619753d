"""Configuration ``mcs3d-cyl-h0.09``: the flagship MCS model of the DFG 3D
channel with a curved cylinder (see the JSON file beside this one).

The program is driven through its public API only: the mesh generator, the
curved cylinder, ``NavierStokesMCS`` with the flagship's arguments and the
inflow scaled by Um, ``FlagshipSolve`` and ``transient_steps``.  Two ops:

* ``simple_step``: set-up solves the initial Stokes state in f64
  (``FlagshipSolve.full_solve``) and builds the f32 stepping twin; each
  unit of the window is one SIMPLE step of the twin, the state carried;
* ``stokes_solve``: each unit is one whole ``full_solve`` from zero, to
  the traffic's ``tol``.

``check`` holds what the window produced against the plain reference
(``perfbench/reference``); ``sizes`` and ``table_bytes`` count the table
bytes a unit needs from the configuration's sizes and the iteration counts
the window reported.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import draw_um, wrap_span

INFLOW, OUTFLOW, WALL = "inlet", "outlet", "wall|cyl"
CHEB_DEGREE = 16  # the step's Chebyshev mass inverse
MAXSTEPS = 2000  # the program's CG iteration cap in the step


class System:
    """The program's objects for one run of one op."""

    def __init__(self, spec: dict, seed: int, traffic: dict, device, parts):
        from navier_stokes_tpu_torch.flagship import (
            FlagshipSolve,
            cylinder_geometry,
            uin,
        )
        from navier_stokes_tpu_torch.mesh.generators import (
            channel_with_cylinder_mesh_3d,
        )
        from navier_stokes_tpu_torch.models import NavierStokesMCS

        self.spec, self.op = spec, traffic["op"]
        self.params = traffic.get("params", {})
        self.um = um = draw_um(spec, seed)

        def inflow(p):
            return um * uin(p)

        with parts("mesh"):
            mesh = channel_with_cylinder_mesh_3d(spec["maxh"])
            geometry = (cylinder_geometry(mesh) if spec.get("curved_order")
                        else None)
        kw = dict(nu=spec["nu"], inflow=INFLOW, outflow=OUTFLOW, wall=WALL,
                  uin=inflow, timestep=spec["dt"], order=spec["order"],
                  assembly_cache={}, device=device, geometry=geometry)
        with parts("model f64"):
            m = NavierStokesMCS(mesh, dtype=torch.float64, **kw)
        tol = self.params.get("tol", spec["stokes"]["tol"])
        with parts("flagship operators"):
            solver = FlagshipSolve(m, tol=tol)
        self.solutions = []
        if self.op == "stokes_solve":
            self.m, self.solver = m, solver
            with parts("warm-up solve"):
                solver.full_solve()
            return
        if self.op != "simple_step":
            raise ValueError(f"unknown op {self.op!r}")
        with parts("initial Stokes solve"):
            res = solver.full_solve()
            u0 = m.u_bc + res.x[0]
        self.start = (u0.cpu().numpy(), res.x[1].cpu().numpy())
        self.start_true_rel = res.true_rel
        del solver, res, m
        with parts("model f32"):
            m32 = NavierStokesMCS(mesh, dtype=torch.float32, **kw)
        with parts("step set-up"):
            m32.make_step_fn(**self.params)
        parts.add({f"step set-up: {k}": v
                   for k, v in m32.setup_seconds.items()})
        self.m32 = m32
        self.states = [u0.to(torch.float32)]
        with parts("warm-up step"):
            self._advance(self.states[0])

    # -- the window ------------------------------------------------------

    def _advance(self, u):
        from navier_stokes_tpu_torch.flagship import transient_steps

        return transient_steps(self.m32, 1, u=u, **self.params)

    def run_unit(self) -> dict:
        if self.op == "stokes_solve":
            res = self.solver.full_solve()
            self.solutions.append((self.m.u_bc + res.x[0], res.x[1]))
            return {"its": res.inner, "failed": not res.rel <= self.solver.tol}
        u, counts = self._advance(self.states[-1])
        self.states.append(u)
        c = counts[0]
        return {"mstar": c["mstar"], "project": c["project"],
                "failed": max(c["mstar"], c["project"]) >= MAXSTEPS}

    def add_spans(self, span):
        """Spans around the calls into the model's layers (traced runs)."""
        if self.op == "stokes_solve":
            for name in ("K32", "pre32", "K_ds", "pre_ds"):
                wrap_span(self.solver, name, span)
            return
        for name, label in (("convection", "convection"),
                            ("_inv_mstar", "mstar_cg"),
                            ("_project_velocity", "projection")):
            wrap_span(self.m32, name, span, label)

    def release(self, rng) -> dict:
        """What the check needs, on the host; the program's state is
        dropped."""
        out = {"um": self.um, "op": self.op}
        if self.op == "stokes_solve":
            out["solutions"] = [(u.cpu().numpy(), p.cpu().numpy())
                                for u, p in self.solutions]
        else:
            n = len(self.states) - 1
            h = min(n, self.spec["step_gap_horizon"])
            picks = (sorted({1, min(2, n), int(rng.integers(1, h + 1)), n})
                     if n else [])
            out["start"] = self.start
            out["pairs"] = [(j, self.states[j - 1].double().cpu().numpy(),
                             self.states[j].double().cpu().numpy())
                            for j in picks]
        self.__dict__.clear()
        return out


# -- the yardstick ----------------------------------------------------------


def check(spec: dict, material: dict, device, log=print) -> list:
    """The numbers compared, each (name, value, limit): the true relative
    residual of each Stokes state the program produced (``stokes_rel``);
    for the sampled steps of the window (the first, the second, one drawn
    from the seed among the first ``step_gap_horizon``, and the last) the
    program's step against the reference's step from the program's own
    state before it: the widest gap relative to the reference's increment
    over the sampled steps up to the horizon (``step_gap``; a step that
    returns its state reads 1), and the widest gap relative to the state
    over all of them (``step_drift``: steady however far the flow has
    settled, where the increments shrink toward nothing)."""
    limits = spec["limits"]
    return [(name, value, limits[name]) for name, value, _ in
            _readings(spec, material, device, log, control=False)]


def control(spec: dict, material: dict, device, log=print) -> list:
    """(name, the program's reading, the control's reading): the control
    of ``stokes_rel`` is the program's f64 state rounded to f32 (the best
    a state held in f32 can read); that of ``step_gap`` and
    ``step_drift`` is the reference's step computed in bfloat16, the
    precision below the step's float32, from the same states."""
    return _readings(spec, material, device, log, control=True)


def _readings(spec, material, device, log, control):
    import time

    from perfbench.reference.systems import (
        SimpleReference,
        StokesReference,
        mcs3d_host,
    )

    def rounded(a):
        return np.asarray(a, np.float32).astype(np.float64)

    t0 = time.perf_counter()
    host = mcs3d_host(spec["maxh"], spec["order"], spec["nu"],
                      bool(spec.get("curved_order")))
    log(f"[reference] host tables {time.perf_counter() - t0:.1f} s")
    um = material["um"]
    if material["op"] == "stokes_solve":
        ref = StokesReference(host, um, torch.float64, device)
        rels = [ref.true_rel(u, p) for u, p in material["solutions"]]
        ctl = ([ref.true_rel(rounded(u), rounded(p))
                for u, p in material["solutions"]] if control else [None])
        return [("stokes_rel", max(rels, default=float("inf")),
                 max(ctl, default=None))]
    t0 = time.perf_counter()
    ref = SimpleReference(host, um, spec["dt"], torch.float64, device)
    log(f"[reference] step set-up {time.perf_counter() - t0:.1f} s, "
        f"Chebyshev bounds ({ref.alpha:.6g}, {ref.beta:.6g})")
    u0, p0 = material["start"]
    out = [("stokes_rel", ref.true_rel(u0, p0),
            ref.true_rel(rounded(u0), rounded(p0)) if control else None)]
    low = (SimpleReference(host, um, spec["dt"], torch.bfloat16, device,
                           maxsteps=spec["control_maxsteps"])
           if control else None)
    horizon = spec["step_gap_horizon"]
    gap, drift = [[], []], [[], []]
    for j, ua, ub in material["pairs"]:
        t0 = time.perf_counter()
        u_ref, k_m, k_p = ref.step(ua)
        ua = torch.as_tensor(ua, device=u_ref.device)
        inc = float(torch.linalg.norm(u_ref - ua))
        state = float(torch.linalg.norm(u_ref))
        outs = [ub] + ([low.step(ua)[0]] if control else [])
        for side, u in enumerate(outs):
            err = float(torch.linalg.norm(
                torch.as_tensor(u, device=u_ref.device).double() - u_ref))
            if j <= horizon:
                gap[side].append(err / inc)
            drift[side].append(err / state)
            log(f"[{'control' if side else 'reference'}] step {j}: gap "
                f"{err / inc:.4e} of the increment {inc:.4e}, "
                f"{err / state:.4e} of the state {state:.4e}"
                + ("" if side else f" (reference CG {k_m} / {k_p}, "
                   f"{time.perf_counter() - t0:.1f} s)"))
    inf = float("inf")
    out.append(("step_gap", max(gap[0], default=inf),
                max(gap[1], default=None)))
    out.append(("step_drift", max(drift[0], default=inf),
                max(drift[1], default=None)))
    return out


def sizes(spec: dict) -> dict:
    """The sizes the byte counts need, from the reference's mesh and
    spaces."""
    from perfbench.reference.assembly import HDiv3D
    from perfbench.reference.fem.quadrature import (
        tetrahedron_rule,
        triangle_rule,
    )
    from perfbench.reference.fem.spaces import H1, L2
    from perfbench.reference.mesh.generators import (
        channel_with_cylinder_mesh_3d,
    )

    mesh = channel_with_cylinder_mesh_3d(spec["maxh"])
    k = spec["order"]
    V = HDiv3D(mesh, k)
    nbv = V.n_basis
    nss_f = k * (k + 1) // 2  # facet order k - 1: scalar modes per face
    Q = L2(mesh, k - 1)
    coarse = H1(mesh, 1, dirichlet=OUTFLOW)
    return {
        "ne": mesh.ne, "nfacet": mesh.nfacet, "nv": mesh.nv,
        "n": V.ndof + mesh.nface * 2 * nss_f, "nq": Q.ndof,
        "nb": nbv + 4 * 2 * nss_f, "nbv": nbv,
        "mq": Q.basis.n_basis,
        "coarse_free": int(coarse.free_mask.sum()),
        "vol_points": len(tetrahedron_rule(3 * k).weights),
        "face_points": len(triangle_rule(2 * k + 2).weights),
    }


def table_bytes(spec: dict, op: str, counts: dict, sz: dict) -> int:
    """Bytes one unit needs: every table byte read once per apply, the
    input vector read and the output written once per apply.

    ``simple_step`` (f32), with k_m M* and k_p projection CG iterations:
    the convection tables once; A once for the right-hand side and once
    per M* iteration; M once per M* iteration and CHEB_DEGREE - 1 times per
    Chebyshev mass inverse, of which there is one per S apply (k_p) and one
    for the correction; B and B^T once each per S apply and once more each
    (the right-hand side, the correction); the element Schur block inverses
    and the dense P1 coarse inverse once per preconditioner apply
    (k_p + 1).  ``stokes_solve`` is not counted (None)."""
    if op != "simple_step":
        return None
    s = 4 if spec["step"]["precision"] == "float32" else 8
    ne, nb, nbv, mq = sz["ne"], sz["nb"], sz["nbv"], sz["mq"]
    n, nq, nc = sz["n"], sz["nq"], sz["coarse_free"]
    k_m, k_p = counts["mstar"], counts["project"]
    elem = ne * nb * nb + 2 * n  # table + vector in and out
    conv = (ne * sz["vol_points"] * 3 * nbv + ne * nbv * sz["vol_points"] * 9
            + 2 * sz["nfacet"] * sz["face_points"] * 3 * nbv + 2 * n)
    b = ne * mq * nb + n + nq
    applies = {
        "A": (k_m + 1, elem),
        "M": (k_m + (CHEB_DEGREE - 1) * (k_p + 1), elem),
        "B": (2 * (k_p + 1), b),
        "S_inv": (k_p + 1, ne * mq * mq + 2 * nq),
        "coarse": (k_p + 1, nc * nc + 2 * sz["nv"]),
        "convection": (1, conv),
    }
    return s * sum(k * per for k, per in applies.values())

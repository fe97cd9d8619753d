"""The flagship solve: the initial Stokes solve of the 3D MCS channel with
cylinder, to a true f64 relative residual of 1e-8.

Counterpart of ``bench.py``'s ``measure`` / ``full_solve``
(bench.py:338-561).  The defaults are bench.py's: the order-3 curved
cylinder, the symmetric multicolor block-GS skeleton preconditioner with
bf16 extension and inverse tables and coarse damping target 1.6, and no
split-k.  ``build_model(curved=False)`` and ``FlagshipSolve(gs=False)``
select the straight additive configuration (``BENCH_STRAIGHT=1
BENCH_GS=0``); ``FlagshipSolve(split_k=k)`` streams the split tables
through the split-k kernels (``NSTPU_SPLITK=k``).  The solve:

* phase 1 -- float32 MINRES refinement passes on the Jacobi-equilibrated
  split-f32 system, with the adaptive pass tolerance, in chunks;
* phase 2 -- MINRES refinement passes on the equilibrated correction system
  with the compensated double-single operators;
* every per-pass residual through the compensated operators, and one
  true-f64 residual (plain f64 torch ops) after the solve.

Usage::

    from navier_stokes_tpu_torch.flagship import FlagshipSolve, build_model
    m = build_model(0.09)                 # CUDA; device="cpu" for the plain
    solver = FlagshipSolve(m)             # PyTorch versions on the CPU
    res = solver.full_solve()             # res.inner, res.seconds, res.true_rel

    straight = build_model(0.09, curved=False)
    additive = FlagshipSolve(straight, gs=False)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .mesh.curved import curve_to_cylinder_3d
from .mesh.generators import channel_with_cylinder_mesh_3d
from .models.navier_stokes_mcs import NavierStokesMCS
from .solvers.minres import minres
from .solvers.refinement import equilibrated_f32_ops

__all__ = ["H", "uin", "cylinder_geometry", "build_model", "FlagshipSolve",
           "FlagshipResult"]

H = 0.41
# MINRES iterations per call: bench.py's defaults (BENCH_CHUNK32/64); a
# pass warm-restarts from the last iterate up to 3 (phase 1) or 6 times
CHUNK32, CHUNK64 = 2000, 1000


def uin(p):
    """Inflow profile of the 3D channel (bench.py:115-118)."""
    out = np.zeros((len(p), 3))
    out[:, 0] = 16 * p[:, 1] * (H - p[:, 1]) * p[:, 2] * (H - p[:, 2]) / H**4
    return out


def cylinder_geometry(mesh):
    """The order-3 curved cylinder of bench.py:121-136 (the reference's
    mesh.Curve(3)).  A failed snap raises: there is no straight fallback."""
    return curve_to_cylinder_3d(mesh, "cyl", (0.5, 0.2), 0.05, order=3)


def build_model(maxh: float = 0.09, order: int = 2, nu: float = 1e-3,
                device=None, assembly_cache: dict | None = None,
                mesh=None, curved: bool = True,
                geometry=None) -> NavierStokesMCS:
    """The bench configuration (bench.py:179-187): curved cylinder unless
    ``curved=False``.  ``mesh`` and its ``geometry``
    (:func:`cylinder_geometry`) are built here unless given."""
    if mesh is None:
        mesh = channel_with_cylinder_mesh_3d(maxh)
    if curved and geometry is None:
        geometry = cylinder_geometry(mesh)
    return NavierStokesMCS(
        mesh, nu=nu, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=uin, timestep=2e-3, order=order, assembly_cache=assembly_cache,
        device=device, geometry=geometry if curved else None,
    )


@dataclass
class FlagshipResult:
    """x: (u, p) f64 correction to the homogeneous problem; rel: the last
    compensated-operator relative residual; true_rel: the true-f64 one;
    inner: total inner MINRES iterations; seconds: solve wall time (the
    true-f64 check excluded); log: one line per refinement pass."""

    x: tuple
    rel: float
    true_rel: float
    inner: int
    seconds: float
    log: list = field(default_factory=list)


class FlagshipSolve:
    """Operators, right-hand side and refinement driver of the flagship
    solve for a built model ``m``.  ``gs`` and ``split_k`` are those of
    :func:`~navier_stokes_tpu_torch.solvers.refinement.equilibrated_f32_ops`,
    with bench.py's defaults."""

    def __init__(self, m: NavierStokesMCS, tol: float = 1e-8,
                 gs: bool = True, split_k: int = 1):
        self.m = m
        self.tol = tol
        self.gs, self.split_k = gs, split_k
        self.setup_seconds = {}
        t0 = time.perf_counter()
        self.ops32, self.D, self.ops_ds = equilibrated_f32_ops(
            m, gs=gs, split_k=split_k)
        self._sync()
        self.setup_seconds["equilibrated ops"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.f_mod = torch.where(m.free, m.f - m.A_raw(m.u_bc), 0.0)
        self.g_mod = -m.B_raw(m.u_bc)
        self.rhs_norm = float(torch.sqrt(
            torch.dot(self.f_mod, self.f_mod)
            + torch.dot(self.g_mod, self.g_mod)))
        self.setup_seconds["rhs"] = time.perf_counter() - t0

    def _sync(self):
        if self.m.device.type == "cuda":
            torch.cuda.synchronize(self.m.device)

    # -- operators ----------------------------------------------------------

    def K32(self, x):
        u, p = x
        o = self.ops32
        return (o["A"](u) + o["BT"](p), o["B"](u))

    def pre32(self, x):
        return (self.ops32["preA"](x[0]), self.ops32["preM"](x[1]))

    def K_ds(self, x):
        u, p = x
        o = self.ops_ds
        return (o["A"](u) + o["BT"](p), o["B"](u))

    def pre_ds(self, x):
        f32, f64 = torch.float32, torch.float64
        return (self.ops32["preA"](x[0].to(f32)).to(f64),
                self.ops32["preM"](x[1].to(f32)).to(f64))

    def residual_pass(self, u0, u1):
        """Residual of the unscaled system through the compensated
        operators: A = D^-1 A~ D^-1, B = B~ D^-1 (bench.py:416-424)."""
        Dinv = 1.0 / self.D
        A, B, BT = self.ops_ds["A"], self.ops_ds["B"], self.ops_ds["BT"]
        return (self.f_mod - Dinv * A(Dinv * u0) - Dinv * BT(u1),
                self.g_mod - B(Dinv * u0))

    def residual64(self, u0, u1):
        """True-f64 residual through the model's f64 operators."""
        m = self.m
        return (self.f_mod - m.A(u0) - m.BT(u1), self.g_mod - m.B(u0))

    def true_rel(self, r0, r1) -> float:
        return float(torch.sqrt(torch.dot(r0, r0) + torch.dot(r1, r1))
                     ) / self.rhs_norm

    # -- the solve -----------------------------------------------------------

    def full_solve(self) -> FlagshipResult:
        """bench.py's ``full_solve``: phase-1 split-f32 MINRES passes, then
        compensated phase-2 passes, to ``tol``.  The true-f64 residual of
        the result is computed after the timed solve."""
        log = []
        self._sync()
        t0 = time.perf_counter()
        x0, x1, rel, inner1 = self.phase1(log, t0)
        x0, x1, rel, inner2 = self.phase2(x0, x1, rel, log, t0)
        self._sync()
        seconds = time.perf_counter() - t0
        true_rel = self.true_rel(*self.residual64(x0, x1))
        return FlagshipResult(x=(x0, x1), rel=rel, true_rel=true_rel,
                              inner=inner1 + inner2, seconds=seconds, log=log)

    def _log(self, log, t0, msg):
        log.append(f"{msg} t={time.perf_counter() - t0:.2f}s")

    def phase1(self, log, t0):
        """Split-f32 MINRES refinement passes from x = 0 with the adaptive
        pass tolerance (bench.py:469-503).  Returns (x0, x1, rel, inner)."""
        TOL, D = self.tol, self.D
        f32, f64 = torch.float32, torch.float64
        x0 = torch.zeros_like(self.f_mod)
        x1 = torch.zeros_like(self.g_mod)
        z32, zp32 = x0.to(f32), x1.to(f32)
        inner = 0
        rel = 1.0
        for _pass in range(8):
            if _pass == 0:
                r0, r1 = self.f_mod, self.g_mod  # x == 0: residual is rhs
            else:
                r0, r1 = self.residual_pass(x0, x1)
            new_rel = self.true_rel(r0, r1)
            self._log(log, t0, f"p1 pass {_pass}: rel={new_rel:.3e} "
                      f"inner={inner}")
            if new_rel <= TOL or (_pass > 0 and new_rel > 0.7 * rel):
                rel = min(rel, new_rel)
                break
            rel = new_rel
            # the inner preconditioned-norm recurrence runs ahead of the true
            # residual: loosen the pass target when little contraction is
            # left (bench.py:484-492)
            tol_pass = float(np.float32(min(1e-3, max(5e-7,
                                                      (TOL / rel) / 256.0))))
            r0s = (D * r0).to(f32)
            r1s = r1.to(f32)
            dx0, dx1 = z32, zp32
            for _c in range(3):
                res = minres(self.K32, (r0s, r1s), pre=self.pre32,
                             sol=(dx0, dx1), initialize=False, tol=tol_pass,
                             maxsteps=CHUNK32, abs_test=False)
                dx0, dx1 = res.x
                inner += res.iterations
                if res.converged:
                    break
            x0 = x0 + D * dx0.to(f64)
            x1 = x1 + dx1.to(f64)
        return x0, x1, rel, inner

    def phase2(self, x0, x1, rel, log, t0, tol=None):
        """Compensated double-single MINRES passes on the equilibrated
        correction system from (x0, x1) at residual ``rel``, to ``tol``
        (default: the solve's), keeping the best iterate when a pass stalls
        (bench.py:504-536).  Returns (x0, x1, rel, inner)."""
        TOL = self.tol if tol is None else tol
        D = self.D
        z64, zp64 = torch.zeros_like(x0), torch.zeros_like(x1)
        inner = 0
        _outer = 0
        while _outer < 6 and rel > TOL:
            r0, r1 = self.residual_pass(x0, x1)
            tol_p2 = min(1e-3, max(1e-4, (TOL / rel) / 16.0))
            dx0, dx1 = z64, zp64
            rounds = 0
            while rounds < 6:
                res = minres(self.K_ds, (D * r0, r1), pre=self.pre_ds,
                             sol=(dx0, dx1), initialize=False, tol=tol_p2,
                             maxsteps=CHUNK64, abs_test=False)
                dx0, dx1 = res.x
                inner += res.iterations
                rounds += 1
                if res.converged:
                    break
            x0n = x0 + D * dx0
            x1n = x1 + dx1
            new_rel = self.true_rel(*self.residual_pass(x0n, x1n))
            self._log(log, t0, f"p2 outer {_outer}: rel={new_rel:.3e} "
                      f"(+{rounds} chunks) inner={inner}")
            if new_rel >= 0.9 * rel:
                break  # stalled at the double-single floor: keep x
            x0, x1, rel = x0n, x1n, new_rel
            _outer += 1
        return x0, x1, rel, inner

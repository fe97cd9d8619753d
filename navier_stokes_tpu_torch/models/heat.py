"""Heat-equation solver: Krylov exponential integrator + Gauss IRK.

Counterpart of ``navier_stokes_tpu/models/heat.py`` (the reference's
heat.py): the 2D heat equation on the unit square, H1 order 10, Dirichlet
on all four sides, advanced by the Krylov-subspace exponential integrator
with a 10-stage Gauss collocation method, and checked against the exact
eigenfunction-decay solution.

Assembly happens once.  The mass and stiffness applies are two
applications of their element tables through the batched local matvec
kernel (``ops.local_mv.batched_local_matvec``: two launches per CG
iteration on the card), kept apart as the JAX package keeps them.  The JAX
package scans the time loop on the device; here the steps are a Python loop
and each substep's inner solve is the port's CG (solvers/cg.py), which
reads one scalar back per iteration.  ``cg_iterations`` and
``step_seconds`` record each solve's count and each step's wall time.  The
convergence study writes the reference's heat_errors.csv schema
(heat.py:161-167) without pandas and returns the rows.
"""

from __future__ import annotations

import time
from math import pi

import numpy as np
import torch

from ..device import resolve_device
from ..fem.spaces import H1
from ..mesh.generators import unit_square_mesh
from ..ops import assembly as asm
from ..precond.jacobi import jacobi
from ..solvers.cg import cg
from ..timestepping.exponential import krylov_exponential_step
from ..timestepping.runge_kutta import implicit_runge_kutta_weights
from ..utils.csvfile import write_csv

__all__ = ["DEFAULT_KL", "HeatEquation", "exact_solution",
           "heat_convergence_study",
           "sum_of_unit_square_laplace_eigenfunctions"]

DEFAULT_KL = [(1, 1), (2, 1), (1, 3), (3, 3), (2, 3), (4, 5), (5, 2)]


def sum_of_unit_square_laplace_eigenfunctions(kl):
    """Initial condition of heat.py:13-18: sum of 2 sin(k pi x) sin(l pi y)."""

    def f(p):
        out = np.zeros(len(p))
        for k, l in kl:
            out += 2.0 * np.sin(k * pi * p[:, 0]) * np.sin(l * pi * p[:, 1])
        return out

    return f


def exact_solution(kl, t):
    """Exact decaying solution of heat.py:21-27."""

    def f(p):
        out = np.zeros(len(p))
        for k, l in kl:
            out += (
                2.0
                * np.exp(-(k**2 + l**2) * pi**2 * t)
                * np.sin(k * pi * p[:, 0])
                * np.sin(l * pi * p[:, 1])
            )
        return out

    return f


class HeatEquation:
    """Setup-once heat solver; ``solve`` advances an initial condition.

    Parameters mirror the reference literals: maxh=0.1, order=10, Dirichlet
    on all four sides (heat.py:31-34), subspace dimension 5 (heat.py:74),
    10-stage Gauss IRK (heat.py:76).  ``device``: CUDA unless the caller
    passes ``"cpu"``.
    """

    def __init__(
        self,
        maxh: float = 0.1,
        order: int = 10,
        rk_stages: int = 10,
        subspace_dimension: int = 5,
        inner_tol: float = 1e-13,
        inner_maxsteps: int = 4000,
        dtype=torch.float64,
        device=None,
    ):
        self.device = device = resolve_device(device)
        self.mesh = unit_square_mesh(maxh)
        self.space = H1(self.mesh, order, dirichlet="bottom|right|top|left")
        self.tables = asm.make_tables(self.space, dtype=dtype, device=device)
        self.mass_local = asm.mass_local(self.tables).contiguous()
        self.stiff_local = asm.stiffness_local(self.tables).contiguous()
        self.free = torch.as_tensor(self.space.free_mask, device=device)
        self.weights = implicit_runge_kutta_weights(rk_stages)
        self.subspace_dimension = subspace_dimension
        self.inner_tol = inner_tol
        self.inner_maxsteps = inner_maxsteps
        self.dtype = dtype
        self.ndof = self.space.ndof
        self.plan = asm.ScatterPlan(self.tables.eldofs, self.ndof)
        self.cg_iterations: list[int] = []
        self.step_seconds: list[float] = []

        plan, n = self.plan, self.ndof
        self._apply_mass = lambda u: asm.apply_local_matrices(
            self.mass_local, plan, n, u, use_kernel=True)
        self._apply_stiff = lambda u: asm.apply_local_matrices(
            self.stiff_local, plan, n, u, use_kernel=True)

    def set_initial(self, initial_temperature) -> torch.Tensor:
        """Nodal interpolation with Dirichlet rows zeroed (heat.py:63-67)."""
        u = self.space.interpolate(initial_temperature)
        u = np.where(self.space.free_mask, u, 0.0)
        return torch.as_tensor(u, device=self.device).to(self.dtype)

    def _heat_ops(self, dt_sub: float):
        """Masked (M + dt_sub K) operator and its Jacobi-preconditioned CG
        solve; each solve's iteration count is appended to
        ``cg_iterations``."""
        free = self.free

        def heat_apply(u):
            uf = torch.where(free, u, 0.0)
            y = self._apply_mass(uf) + dt_sub * self._apply_stiff(uf)
            return torch.where(free, y, u)

        diag = asm.diagonal_of_local(
            self.mass_local + dt_sub * self.stiff_local, self.plan, self.ndof)
        pre = jacobi(diag, free)

        def heat_solve(r):
            rf = torch.where(free, r, 0.0)
            res = cg(heat_apply, rf, pre=pre, tol=self.inner_tol,
                     maxsteps=self.inner_maxsteps)
            self.cg_iterations.append(res.iterations)
            return res.x

        return heat_apply, heat_solve

    def solve(self, initial_temperature, end_time: float, time_step: float):
        """Advance to >= end_time in steps of ``time_step``.

        Returns (T, final_time); like the reference while-loop
        (heat.py:81), the final time is the first multiple of time_step
        reaching end_time (it may overshoot; errors are evaluated there).
        ``cg_iterations`` and ``step_seconds`` start afresh.
        """
        T = self.set_initial(initial_temperature)
        n_steps = int(np.ceil(end_time / time_step - 1e-12))
        final_time = n_steps * time_step
        _, heat_solve = self._heat_ops(time_step / self.subspace_dimension)
        self.cg_iterations, self.step_seconds = [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            T = krylov_exponential_step(
                T, self._apply_stiff, self._apply_mass, heat_solve,
                self.weights, time_step, self.subspace_dimension)
            if T.is_cuda:
                torch.cuda.synchronize(T.device)
            self.step_seconds.append(time.perf_counter() - t0)
        return T, final_time

    def l2_error(self, T: torch.Tensor, exact) -> float:
        """sqrt(integral (T_h - exact)^2) via quadrature (heat.py:158-159)."""
        t = self.tables
        u = T.cpu().numpy()
        uq = np.einsum("qi,ei->eq", t.val.cpu().numpy(),
                       u[self.space.element_dofs])
        exq = exact(t.qpts.cpu().numpy().reshape(-1, self.mesh.dim)).reshape(
            uq.shape)
        return float(
            np.sqrt(
                np.einsum("q,eq,e->", t.qw.cpu().numpy(), (uq - exq) ** 2,
                          t.detj.cpu().numpy())
            )
        )


def heat_convergence_study(
    kl=DEFAULT_KL,
    time_steps=None,
    end_time: float = 0.05,
    data_file: str | None = "heat_errors.csv",
    **heat_kwargs,
):
    """The heat.py:151-167 convergence study: L2 error vs time step.

    Writes the reference CSV schema (columns time_step, error) when
    ``data_file`` is given and returns the rows (one dict per time step).
    """
    if time_steps is None:
        time_steps = np.logspace(-1, -4, num=7).tolist()
    model = HeatEquation(**heat_kwargs)
    initial = sum_of_unit_square_laplace_eigenfunctions(kl)
    rows = []
    for ts in time_steps:
        T, final_time = model.solve(initial, end_time, ts)
        err = model.l2_error(T, exact_solution(kl, final_time))
        rows.append({"time_step": ts, "error": err})
    if data_file:
        write_csv(rows, ("time_step", "error"), data_file)
    return rows

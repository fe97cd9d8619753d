"""Steady Stokes: operator setup, BPCG/MINRES drivers, benchmark harness.

Counterpart of ``navier_stokes_tpu/models/stokes.py`` (the reference's
run.py):

* forms a = integral grad(u):grad(v), b = integral div(u) q, mp = pressure
  mass (run.py:77-84) as masked matrix-free operators from element
  matrices: the vector Laplacian is the scalar stiffness table applied once
  per velocity component through the hand-written batched local matvec
  (``ops.local_mv.batched_local_matvec``, one launch per component on the
  card); the rectangular divergence coupling B and its transpose stay
  einsums, as in the JAX package;
* rhs f = integral (x-0.5) v_y (run.py:93), parabolic inlet profile
  1.5*4y(0.41-y)/0.41^2 on the x-component (run.py:101-104);
* Dirichlet lifting: solve for the correction du with homogeneous
  constraints;
* solver adapters for Bramble-Pasciak CG and block-preconditioned MINRES
  (run.py:32-56) and the sweep harness writing the exact errors.csv schema
  (run.py:244-262) without pandas (utils/csvfile.py).  The harness returns
  the rows (one dict each) where the JAX package returns a pandas
  ``DataFrame``.

Host tables are numpy in f64; the operators are torch on ``device`` (CUDA
unless the caller passes ``device="cpu"``).  The 3D hybrid builder
(models/stokes_hybrid3d.build_hybrid_stokes_system_3d) and the HDG builder
(models/stokes_hybrid.build_hybrid_stokes_system) return a
:class:`StokesSystem` too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..ops import assembly as asm
from ..precond.jacobi import jacobi
from ..solvers.bpcg import (
    bp_scale_factor,
    bramble_pasciak_cg,
    bramble_pasciak_cg_opt,
)
from ..solvers.minres import minres
from ..utils.csvfile import write_csv
from ..utils.timers import Timer

__all__ = ["CSV_COLUMNS", "StokesSystem", "build_stokes_system",
           "default_inlet_profile", "default_volume_force", "run", "solve",
           "solve_with_bramble_pasciak_cg", "solve_with_min_res"]

# the errors.csv columns of reference run.py:244-259, after the unnamed
# index column
CSV_COLUMNS = ("mesh_size", "discretization", "order", "solver",
               "iteration", "error", "solver_time", "nvertices", "nedges",
               "nfaces", "nfacets", "nelements", "ndofs", "method")


def default_inlet_profile(height: float = 0.41, mean_factor: float = 1.5):
    """Parabolic inlet u_x = 1.5 * 4 y (H - y) / H^2 (run.py:101)."""

    def uin(p):
        ux = mean_factor * 4.0 * p[:, 1] * (height - p[:, 1]) / (height
                                                                 * height)
        out = np.zeros((len(p), p.shape[1]))
        out[:, 0] = ux
        return out

    return uin


def default_volume_force(p):
    """f = (0, x - 0.5): the reference's benchmark forcing (run.py:93)."""
    out = np.zeros((len(p), p.shape[1]))
    out[:, 1] = p[:, 0] - 0.5
    return out


@dataclass
class StokesSystem:
    """Masked matrix-free operators + rhs for the saddle system
    [[A, B^T], [B, 0]] (du, p) = (f_mod, g_mod), with u = u_bc + du.
    ``tables``: the square element tables the operators apply through the
    batched local matvec (name -> (ne, nb, nb) tensor)."""

    V: object
    Q: object
    A: Callable
    B: Callable
    BT: Callable
    preA: Callable
    preM: Callable
    f: torch.Tensor
    g: torch.Tensor
    u_bc: torch.Tensor
    ndofs: int
    tables: dict | None = None

    def lift(self, du: torch.Tensor) -> torch.Tensor:
        return self.u_bc + du


def build_stokes_system(
    mesh,
    discretization,
    velocity_dirichlet: str = "wall|inlet|cyl",
    uin=None,
    volume_force=default_volume_force,
    dtype=torch.float64,
    a_pre: str = "jacobi",
    geometry=None,
    device=None,
) -> StokesSystem:
    """The mixed (H1-type velocity x pressure) system of run.py:71-111.

    ``geometry``: optional CurvedGeometry for isoparametric (curved
    cylinder) elements -- the mesh.Curve(3) parity path (run.py:28).
    ``a_pre``: ``"jacobi"`` (the assembled diagonal) or ``"twolevel"``
    (vertex-patch smoother + P1 coarse solve, per component)."""
    device = resolve_device(device)
    V, Q = discretization(mesh, velocity_dirichlet)
    Vs = V.scalar
    d, n = mesh.dim, Vs.ndof
    qd = 2 * max(Vs.order, Q.order, 1)
    if geometry is not None:
        qd += 2 * (geometry.order - 1)
    tu = asm.make_tables(Vs, qd, dtype, geometry=geometry, device=device)
    tp = asm.make_tables(Q, qd, dtype, geometry=geometry, device=device)
    K_loc = asm.stiffness_local(tu).contiguous()
    Mp_loc = asm.mass_local(tp)
    D_loc = asm.divergence_local(tp, tu)

    free_s = torch.as_tensor(Vs.free_mask, device=device)
    plan_u = asm.ScatterPlan(tu.eldofs, n)
    plan_p = asm.ScatterPlan(tp.eldofs, Q.ndof)
    eldofs_u, eldofs_p = tu.eldofs, tp.eldofs

    def A_raw(u2):  # (d, n) -> (d, n), unmasked vector Laplacian
        return torch.stack([
            asm.apply_local_matrices(K_loc, plan_u, n, u2[c], use_kernel=True)
            for c in range(d)])

    def B_raw(u2):  # (d, n) -> (Q.ndof,)
        ue = u2[:, eldofs_u]  # (d, ne, nbu)
        pe = torch.einsum("eijc,cej->ei", D_loc, ue)
        return plan_p(pe)

    def A(u):
        u2 = u.reshape(d, n)
        uf = torch.where(free_s[None], u2, 0.0)
        y = A_raw(uf)
        y = torch.where(free_s[None], y, u2)  # identity on constrained dofs
        return y.reshape(-1)

    def B(u):
        u2 = torch.where(free_s[None], u.reshape(d, n), 0.0)
        return B_raw(u2)

    def BT(p):
        pe = p[eldofs_p]
        ue = torch.einsum("eijc,ei->cej", D_loc, pe)
        y = torch.stack([plan_u(ue[c]) for c in range(d)])
        y = torch.where(free_s[None], y, 0.0)
        return y.reshape(-1)

    tables = {"K_loc": K_loc}
    # A-preconditioner: two-level additive Schwarz (the BDDC stand-in) or
    # Jacobi; Schur preconditioner = pressure-mass Jacobi (the reference's
    # 'local', run.py:62)
    if a_pre == "twolevel":
        from ..precond.twolevel import two_level_preconditioner

        pre_s = two_level_preconditioner(
            Vs, K_loc.cpu().numpy(), coefficient=1.0, smoother="patch",
            dtype=dtype, device=device)
        tables["patch_inverses"] = pre_s.table

        def preA(u):
            u2 = u.reshape(d, n)
            return torch.stack([pre_s(u2[c]) for c in range(d)]).reshape(-1)

    elif a_pre == "jacobi":
        diag_K = asm.diagonal_of_local(K_loc, plan_u, n)
        diag_K = torch.where(free_s, diag_K, 1.0)
        inv_diag_K = 1.0 / diag_K

        def preA(u):
            u2 = u.reshape(d, n)
            return (inv_diag_K[None] * u2).reshape(-1)

    else:
        raise ValueError(f"unknown a_pre {a_pre!r}")

    diag_Mp = asm.diagonal_of_local(Mp_loc, plan_p, Q.ndof)
    preM = jacobi(diag_Mp)

    # rhs: volume force in each component + Dirichlet lifting
    fq = volume_force(tu.qpts.cpu().numpy().reshape(-1, d)).reshape(
        tu.qpts.shape[0], tu.qpts.shape[1], d)
    f_full = torch.stack([
        plan_u(asm.linear_form_local(
            tu, torch.as_tensor(fq[:, :, c], device=device).to(dtype)))
        for c in range(d)])  # (d, n)

    if uin is None:
        u_bc = torch.zeros((d, n), dtype=dtype, device=device)
    else:
        u_bc = torch.as_tensor(
            V.interpolate_boundary(uin, "inlet").reshape(d, n),
            device=device).to(dtype)

    f_mod = torch.where(free_s[None], f_full - A_raw(u_bc), 0.0).reshape(-1)
    g_mod = -B_raw(u_bc)  # g = 0 in the reference (run.py:96-97)

    return StokesSystem(
        V=V, Q=Q, A=A, B=B, BT=BT, preA=preA, preM=preM,
        f=f_mod, g=g_mod, u_bc=u_bc.reshape(-1), ndofs=V.ndof + Q.ndof,
        tables=tables,
    )


def _trim_errors(errors: np.ndarray) -> list[float]:
    e = np.asarray(errors)
    return e[~np.isnan(e)].tolist()


def solve_with_bramble_pasciak_cg(
    system: StokesSystem, tolerance: float = 1e-7, max_steps: int = 10000,
    optimized: bool = False, scale_k=None, v0=None, result=None,
):
    """run.py:32-41 equivalent; returns (u, p, errors, time, ndofs).

    ``scale_k``: the Bramble-Pasciak scaling, else from 40 Lanczos steps
    started at ``v0`` (solvers/bpcg.bp_scale_factor; the JAX package starts
    them from ``jax.random.PRNGKey(0)``, which the port cannot draw, so a
    run held to its counts passes its k).  ``result``: a dict that receives
    the solver's result (``"result"``) and the k (``"scale_k"``)."""
    if scale_k is None:
        scale_k, _ = bp_scale_factor(system.A, system.preA, system.f, v0=v0)
    timer = Timer("BramblePasciakCG").Start()
    if optimized:
        res = bramble_pasciak_cg_opt(
            system.A, system.B, system.BT, system.preA, system.preM,
            system.f, system.g, tol=tolerance, maxsteps=max_steps,
            scale_k=scale_k)
    else:
        res = bramble_pasciak_cg(
            system.A, system.B, system.BT, system.preA, system.preM,
            system.f, system.g, tol=tolerance, max_steps=max_steps,
            scale_k=scale_k)
    timer.Stop(res.x)
    if result is not None:
        result.update(result=res, scale_k=scale_k)
    u = system.lift(res.x[0])
    return u, res.x[1], _trim_errors(res.errors), timer.time, system.ndofs


def solve_with_min_res(
    system: StokesSystem, tolerance: float = 1e-7, max_steps: int = 10000,
    result=None,
):
    """run.py:44-56 equivalent: block system + block-diagonal
    preconditioner.  ``result``: a dict that receives the solver's result
    (``"result"``)."""

    def K(x):
        u, p = x
        return (system.A(u) + system.BT(p), system.B(u))

    def C(x):
        return (system.preA(x[0]), system.preM(x[1]))

    timer = Timer("MinRes").Start()
    res = minres(K, (system.f, system.g), pre=C, tol=tolerance,
                 maxsteps=max_steps)
    timer.Stop(res.x)
    if result is not None:
        result.update(result=res)
    u = system.lift(res.x[0])
    return u, res.x[1], _trim_errors(res.errors), timer.time, system.ndofs


def solve(mesh, discretization, solver, **system_kwargs):
    """run.py:71-111 equivalent driver for the standard mixed formulation."""
    if "uin" not in system_kwargs:
        system_kwargs["uin"] = default_inlet_profile()
    system = build_stokes_system(mesh, discretization, **system_kwargs)
    u, p, errors, time, ndofs = solver(system)
    return u, p, errors, time, ndofs


def run(
    mesh_sizes,
    methods,
    solver_factories,
    data_file: str = "errors.csv",
    profiling_enabled: bool = False,
    mesh_factory=None,
):
    """Sweep harness with the exact CSV schema of run.py:227-262; returns
    the rows, one dict per (solve, iteration)."""
    from ..mesh.generators import channel_with_cylinder_mesh
    from ..utils.profiling import maybe_profile

    if mesh_factory is None:
        mesh_factory = channel_with_cylinder_mesh

    rows: list[dict] = []
    for mesh_size in mesh_sizes:
        mesh = mesh_factory(mesh_size)
        for method_name, method_map in methods.items():
            solve_method = method_map["solve"]
            discretizations = method_map["discretizations"]
            for disc_name, (discretization, order) in discretizations.items():
                for solver_name, solver in solver_factories.items():
                    print(f"solving with {disc_name}, {solver_name}, "
                          f"h={mesh_size}")
                    with maybe_profile(profiling_enabled):
                        _, _, errors, solver_time, ndofs = solve_method(
                            mesh, discretization, solver
                        )
                    for it, err in enumerate(errors):
                        rows.append({
                            "mesh_size": mesh_size,
                            "discretization": disc_name,
                            "order": order,
                            "solver": solver_name,
                            "iteration": it,
                            "error": err,
                            "solver_time": solver_time,
                            "nvertices": mesh.nv,
                            "nedges": mesh.nedge,
                            "nfaces": mesh.nface,
                            "nfacets": mesh.nfacet,
                            "nelements": mesh.ne,
                            "ndofs": ndofs,
                            "method": method_name,
                        })
    write_csv(rows, CSV_COLUMNS, data_file)
    return rows

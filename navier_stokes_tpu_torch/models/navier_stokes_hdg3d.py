"""3D Navier-Stokes on H(div) (BDM) velocity with HDG viscous coupling.

Counterpart of ``navier_stokes_tpu/models/navier_stokes_hdg3d.py`` (the 3D
use of the reference's NavierStokesSIMPLE_iterative.py in
templates/NavierStokesSIMPLE_test_3D.py): H(div)-conforming BDM velocity
(pointwise divergence-free after projection), tangential coupling through
facet unknowns, upwind-DG convection, the same SolveInitial / AddForce /
DoTimeStep / Project API and recorded BPCG metrics.  The viscous operator
is the interior-penalty HDG form (models/stokes_hybrid3d.py) rather than
the mixed-stress MCS form.

The element tables are assembled once on the host in f64 numpy, as the JAX
model's, and live on ``device`` in the model's ``dtype``.  Every square
per-element product -- the viscous operator A, the velocity mass, M* and
the mass inverse's applies -- goes through the hand-written
``batched_local_matvec`` (its plain version on the CPU), every scatter
through a deterministic ``ScatterPlan``; B and B^T are plain products, as
in the JAX model.  The A-preconditioner is the vertex-star block smoother
with the vector-P1 coarse correction (``preconditioner="auxspace"``,
models/auxspace3d.py; its block inverses are taken on the device) or the
face blocks (``"faceblock"``).  The convection tables and the Chebyshev
mass inverse are built at first use; ``setup_seconds`` has the seconds of
each setup part.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..fem.quadrature import tetrahedron_rule
from ..ops.assembly import (
    ScatterPlan,
    apply_local_matrices,
    diagonal_of_local,
    mass_diagonal,
)
from ..ops.convection3d import build_upwind_convection_3d
from ..precond.chebyshev import chebyshev_preconditioner
from ..solvers.bpcg import bp_scale_factor, bramble_pasciak_cg_opt
from ..solvers.cg import cg
from ..utils.timers import Timer
from ..utils.tracing import traced
from .auxspace3d import build_auxspace_preconditioner_3d
from .stokes_hybrid3d import (
    piola_values,
    assemble_hdg_stokes_3d,
    bdm_hybrid_3d,
    build_faceblock_preconditioner_3d,
    interpolate_hybrid_boundary_3d,
)

__all__ = ["NavierStokesHDG3D"]


class NavierStokesHDG3D:
    """3D HDG model: spaces, element operators, the initial Stokes solve
    and the transient SIMPLE step.

    ``device``: CUDA unless the caller passes ``device="cpu"``.  ``dtype``:
    float64, or float32 for a twin (``solvers.refinement.
    solve_initial_refined`` takes an f64 / f32 pair).  ``alpha``: the
    interior penalty.  ``preconditioner``: ``"auxspace"`` or
    ``"faceblock"``.  ``assembly_cache``: a dict whose ``hdg3d`` entry
    (the tables of :func:`~.stokes_hybrid3d.assemble_hdg_stokes_3d`)
    replaces host assembly; filled in when it is missing, so that a twin of
    the same mesh, order, nu and alpha skips it."""

    def __init__(self, mesh, nu: float, inflow: str, outflow: str,
                 wall: str, uin, timestep: float, order: int = 2,
                 volumeforce=None, dtype=torch.float64, alpha: float = 10.0,
                 preconditioner: str = "auxspace",
                 assembly_cache: dict | None = None, device=None):
        if mesh.dim != 3:
            raise ValueError("NavierStokesHDG3D needs a 3D mesh")
        if dtype not in (torch.float64, torch.float32):
            raise TypeError(f"dtype {dtype} is neither float64 nor float32")
        if preconditioner not in ("auxspace", "faceblock"):
            raise ValueError(f"unknown preconditioner {preconditioner!r}: "
                             "'auxspace' or 'faceblock'")
        self.device = dev = resolve_device(device)
        self.nu, self.timestep, self.uin = nu, timestep, uin
        self.inflow, self.outflow, self.wall = inflow, outflow, wall
        self.mesh, self.order, self.dtype = mesh, order, dtype
        self.preconditioner = preconditioner
        self.setup_seconds = {}
        self.last_iterations = {}

        dirich = inflow + "|" + wall
        self._dirich = dirich
        disc, _ = bdm_hybrid_3d(order)
        self.Xv, self.Q = disc(mesh, dirich)
        V = self.Xv
        t0 = time.perf_counter()
        if assembly_cache is not None and "hdg3d" in assembly_cache:
            A_np, B_np, force_local, M_full = assembly_cache["hdg3d"]
        else:
            A_np, B_np, force_local, _, _ = assemble_hdg_stokes_3d(
                V, self.Q, alpha=alpha, nu=nu)
            M_full = self._velocity_mass(A_np.shape[1])
            if assembly_cache is not None:
                assembly_cache["hdg3d"] = (A_np, B_np, force_local, M_full)
        self.A_np = A_np
        self._force_local = force_local
        self.n = n = V.ndof
        self.free_np = V.free_mask
        self.free = free = torch.as_tensor(self.free_np, device=dev)
        self._nbv_total = V.hdiv.ndof
        self.setup_seconds["assembly"] = time.perf_counter() - t0

        def ship(a):
            return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

        t0 = time.perf_counter()
        self.plan_v = ScatterPlan(torch.as_tensor(V.element_dofs, device=dev),
                                  n)
        self.plan_p = ScatterPlan(
            torch.as_tensor(self.Q.element_dofs, device=dev), self.Q.ndof)
        self.eldofs = self.plan_v.index
        self.eldofs_p = self.plan_p.index
        self.A_loc = A_loc = ship(A_np).contiguous()
        self.M_loc = M_loc = ship(M_full).contiguous()
        B_loc = ship(B_np)
        plan_v, plan_p = self.plan_v, self.plan_p

        def A_raw(u):
            return apply_local_matrices(A_loc, plan_v, n, u, use_kernel=True)

        def mass_raw(u):
            return apply_local_matrices(M_loc, plan_v, n, u, use_kernel=True)

        def A(u):
            uf = torch.where(free, u, 0.0)
            return torch.where(free, A_raw(uf), u)

        dt = timestep

        def mstar(u):
            uf = torch.where(free, u, 0.0)
            y = mass_raw(uf) + dt * A_raw(uf)
            return torch.where(free, y, u)

        def B_raw(u):
            return plan_p(torch.einsum("epi,ei->ep", B_loc, u[plan_v.index]))

        def B(u):
            return B_raw(torch.where(free, u, 0.0))

        def BT(p):
            ue = torch.einsum("epi,ep->ei", B_loc, p[plan_p.index])
            return torch.where(free, plan_v(ue), 0.0)

        self.A, self.A_raw, self.mstar = A, A_raw, mstar
        self.B, self.B_raw, self.BT = B, B_raw, BT

        # the diagonal of M + dt A, entry by entry as the JAX model's
        diagM = plan_v(torch.diagonal(M_loc, dim1=1, dim2=2)
                       + dt * torch.diagonal(A_loc, dim1=1, dim2=2))
        diagM = torch.where(free & (diagM.abs() > 1e-30), diagM.abs(), 1.0)
        self.preMstar = lambda u: torch.where(free, u / diagM, u)
        diagMv = diagonal_of_local(M_loc, plan_v, n)
        diagMv = torch.where(free & (diagMv.abs() > 1e-30), diagMv, 1.0)
        self._preMv = lambda u: torch.where(free, u / diagMv, u)
        diag_Mp = ship(mass_diagonal(self.Q))
        self.preM = lambda p: nu * p / diag_Mp
        self._preM_proj = lambda p: p / diag_Mp

        umask = torch.arange(n, device=dev) < self._nbv_total
        self._umask = umask
        fu = free & umask

        def Mv(u):
            y = mass_raw(torch.where(fu, u, 0.0))
            return torch.where(fu, y, u)

        self._Mv = Mv
        self.setup_seconds["operators"] = self._synced(t0)

        # the steady A's preconditioner (a diagonal is too weak for the
        # penalty-dominated HDG operator)
        t0 = time.perf_counter()
        if preconditioner == "auxspace":
            self.preA = build_auxspace_preconditioner_3d(
                V, A_np, dirich, dtype, coarse_coefficient=nu, device=dev)
        else:
            self.preA = build_faceblock_preconditioner_3d(V, A_np, dtype,
                                                          device=dev)
        self.setup_seconds["preconditioner"] = self._synced(t0)

        self._uin_np = self._wrap_uin(uin)
        self._conv_v = None
        self._mass_cheb = None

        self.f = torch.zeros(n, dtype=dtype, device=dev)
        if volumeforce is not None:
            self.AddForce(volumeforce)
        t0 = time.perf_counter()
        self.u_bc = ship(interpolate_hybrid_boundary_3d(V, self._uin_np,
                                                        inflow))
        self.setup_seconds["boundary values"] = time.perf_counter() - t0
        self.u = self.u_bc
        self.p = torch.zeros(self.Q.ndof, dtype=dtype, device=dev)
        self.stokes_bpcg_iterations = None
        self.stokes_bpcg_time = None
        self.stokes_bpcg_scale_k = None

    # ------------------------------------------------------------------

    def _velocity_mass(self, n_ret: int) -> np.ndarray:
        """(ne, n_ret, n_ret) velocity mass table: the Piola-mapped H(div)
        block, zero on the facet dofs (host f64, one batched product)."""
        hd = self.Xv.hdiv
        nbv = hd.n_basis
        J, detJ, _ = self.mesh.element_jacobians
        vol = tetrahedron_rule(2 * self.order + 2)
        v_val, _ = hd.tabulate_elements(vol.points)
        ne, nq = v_val.shape[:2]
        val_p = piola_values(J, v_val) / detJ[:, None, None, None]
        Vt = val_p.transpose(0, 2, 1, 3).reshape(ne, nbv, nq * 3)
        wq = np.repeat(vol.weights, 3)[None, :] * detJ[:, None]
        M_full = np.zeros((ne, n_ret, n_ret))
        M_full[:, :nbv, :nbv] = np.matmul(Vt * wq[:, None, :],
                                          Vt.transpose(0, 2, 1))
        return M_full

    def _synced(self, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def load_state(self, u=None, p=None, cheb_bounds=None):
        """Take up another model's state, given as numpy: the velocity and
        pressure dof vectors and the (alpha, beta) bounds of its Chebyshev
        mass inverse (which then replace the Lanczos estimate)."""
        if u is not None:
            u = np.array(u)
            if u.shape != (self.n,):
                raise ValueError(f"u of shape {u.shape}, expected {(self.n,)}")
            self.u = torch.as_tensor(u, device=self.device).to(self.dtype)
        if p is not None:
            p = np.array(p)
            if p.shape != (self.Q.ndof,):
                raise ValueError(
                    f"p of shape {p.shape}, expected {(self.Q.ndof,)}")
            self.p = torch.as_tensor(p, device=self.device).to(self.dtype)
        if cheb_bounds is not None:
            alpha, beta = (float(b) for b in cheb_bounds)
            self._mass_cheb = None
            self._mass_chebyshev(bounds=(alpha, beta))

    def _wrap_uin(self, uin):
        def f(p):
            out = np.asarray(uin(p))
            if out.ndim == 1:
                full = np.zeros((len(p), 3))
                full[:, 0] = out
                return full
            return out

        return f

    def _build_convection(self):
        if self._conv_v is None:
            t0 = time.perf_counter()
            self._conv_v = build_upwind_convection_3d(
                self.Xv.hdiv, self._uin_np, dtype=self.dtype,
                device=self.device)
            self.setup_seconds["convection"] = self._synced(t0)
        return self._conv_v

    def convection(self, u):
        conv = self._build_convection()
        nbv = self._nbv_total
        return torch.cat([conv(u[:nbv]), u.new_zeros(self.n - nbv)])

    @property
    def velocity(self) -> np.ndarray:
        return self.u[: self._nbv_total].cpu().numpy()

    @property
    def pressure(self) -> np.ndarray:
        return -self.p.cpu().numpy()

    def AddForce(self, force):
        """Add the load of the volume force ``force`` (points (N, 3) ->
        values (N, 3)) to the right-hand side ``f``."""
        fe = self._force_local(force)
        out = np.zeros(self.n)
        np.add.at(out, self.Xv.element_dofs.ravel(), fe.ravel())
        self.f = self.f + torch.as_tensor(out, device=self.device).to(
            self.dtype)

    @traced("stokes_solve")
    def SolveInitial(self, timesteps=None, iterative: bool = True,
                     GS: bool = True, tol: float = 1e-8,
                     maxsteps: int = 100000, scale_k=None):
        """The initial Stokes solve from the boundary data, as the JAX
        model's: Bramble-Pasciak CG (v2, ``rel_err=True``) on
        A du + B^T p = f - A u_bc, B du = -B u_bc with ``preA`` and
        ``preM``, to ``tol``.  Sets ``u``, ``p``,
        ``stokes_bpcg_iterations``, ``stokes_bpcg_time`` (the named timer
        ``stokes-bpcg`` over the right-hand side, the Lanczos scaling and
        the iteration) and ``stokes_bpcg_scale_k``; returns the solver's
        result.  ``scale_k``: the Bramble-Pasciak scaling, from Lanczos
        when None.  ``iterative`` and ``GS`` are the reference's flags,
        unused as in the JAX model.

        ``timesteps`` = n instead: n pseudo-time Stokes steps from the
        current state, each projected; returns None."""
        if timesteps:
            self.Project()
            for _ in range(timesteps):
                temp = torch.where(self.free, -self.A_raw(self.u), 0.0)
                temp2, _ = self._project_velocity(self._inv_mstar(temp))
                self.u = self.u + self.timestep * temp2
                self.Project()
            return None

        timer = Timer("stokes-bpcg").Start()
        f_mod = torch.where(self.free, self.f - self.A_raw(self.u_bc), 0.0)
        g_mod = -self.B_raw(self.u_bc)
        if scale_k is None:
            scale_k, _ = bp_scale_factor(self.A, self.preA, f_mod)
        res = bramble_pasciak_cg_opt(
            self.A, self.B, self.BT, self.preA, self.preM, f_mod, g_mod,
            tol=tol, maxsteps=maxsteps, rel_err=True, scale_k=scale_k)
        timer.Stop(res.x)
        self.u = self.u_bc + res.x[0]
        self.p = res.x[1]
        self.stokes_bpcg_iterations = int(res.iterations)
        self.stokes_bpcg_time = timer.time
        self.stokes_bpcg_scale_k = float(scale_k)
        return res

    def _inv_mstar(self, rhs, precision: float = 1e-4, maxsteps: int = 2000):
        res = cg(self.mstar, rhs, pre=self.preMstar, tol=precision,
                 maxsteps=maxsteps)
        self.last_iterations["mstar"] = res.iterations
        return res.x

    def _mass_chebyshev(self, degree: int = 16, bounds=None):
        """Fixed-degree Chebyshev approximation of Mv^{-1}, built once:
        ``bounds`` (alpha, beta) replace the Lanczos estimate of the first
        call (``.bounds`` of the result carries them to another model)."""
        if self._mass_cheb is None:
            t0 = time.perf_counter()
            self._mass_cheb = chebyshev_preconditioner(
                self._Mv, self._preMv, self.u_bc, degree=degree,
                bounds=bounds, lower_fraction=0.02)
            self.setup_seconds["mass chebyshev"] = self._synced(t0)
        return self._mass_cheb

    def _project_velocity(self, u, tol: float = 1e-9, maxsteps: int = 2000):
        Minv = self._mass_chebyshev()

        def S(p):
            return self.B(Minv(self.BT(p)))

        rhs = self.B_raw(u)
        pres = cg(S, rhs, pre=self._preM_proj, tol=tol, maxsteps=maxsteps)
        self.last_iterations["project"] = pres.iterations
        return u - Minv(self.BT(pres.x)), pres.x

    def Project(self, vel=None):
        if vel is None:
            self.u, self.p = self._project_velocity(self.u)
            return None
        u_new, self.p = self._project_velocity(vel)
        return u_new

    def make_step_fn(self, project_tol: float = 1e-9,
                     mstar_tol: float = 1e-4):
        """The SIMPLE step u -> u + dt * P(M*^-1 (conv(u) + f - A u)) as a
        function of the state; the defaults are DoTimeStep's (the JAX
        model's).  The lazy setup (convection tables, Chebyshev bounds)
        happens here, not in the first step."""
        self._mass_chebyshev()
        self._build_convection()
        free, f, dt = self.free, self.f, self.timestep
        conv, A_raw = self.convection, self.A_raw
        inv_mstar, project = self._inv_mstar, self._project_velocity

        def step(u):
            temp = conv(u) + f - A_raw(u)
            temp = torch.where(free, temp, 0.0)
            temp2, _ = project(inv_mstar(temp, precision=mstar_tol),
                               tol=project_tol)
            return u + dt * temp2

        return step

    def DoTimeStep(self):
        if getattr(self, "_step", None) is None:
            self._step = self.make_step_fn()
        self.u = self._step(self.u)

"""Taylor-Hood Navier-Stokes with the reference's SIMPLE-style API, 2D and 3D.

Counterpart of ``navier_stokes_tpu/models/navier_stokes.py``: H1_k^dim
velocity, H1_{k-1} pressure with grad-div stabilization, and the class
signature, ``SolveInitial`` / ``AddForce`` / ``DoTimeStep`` / ``Project``,
the velocity/pressure properties and the recorded
``stokes_bpcg_iterations`` / ``stokes_bpcg_time`` of the reference's
NavierStokesSIMPLE_iterative.py:15,168,397-399,422-444.

* SolveInitial (steady): Bramble-Pasciak CG (solvers/bpcg.py, v2) on the
  Stokes saddle system A = nu * viscous + grad-div, preM = the
  viscosity-scaled pressure-mass Jacobi, tol 1e-10; A is preconditioned
  per component by the two-level additive Schwarz of precond/twolevel.py
  (vertex-patch blocks + the P1 coarse solve), or by its diagonal.
* DoTimeStep: explicit convection -(u.grad)u, implicit Stokes step through
  mstar = M + dt A by inner CG at precision 1e-4, then the divergence-free
  projection (the Schur CG on B M^-1 B^T with a Chebyshev mass inverse).

The element tables are computed in torch from ``ops.assembly.make_tables``
(in the model's ``dtype`` on ``device``, as the JAX model's jnp tables).
The viscous + grad-div operator is stored as ONE square table per element,
(ne, nb*d, nb*d) with the component innermost, and the velocity mass as
(ne, nb, nb) applied per component: every square element product --
stokesA, the mass, M* and Mv -- goes through the hand-written
``batched_local_matvec``; the rectangular B, B^T and the convection are
plain products; every scatter is a deterministic ``ScatterPlan``.

State is a flat (d*n,) component-major velocity vector and the (nQ,)
pressure; ``velocity`` gives (d, n).  ``load_state`` takes up another
model's velocity, pressure and Chebyshev bounds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..fem.spaces import H1, VectorSpace
from ..ops import assembly as asm
from ..ops.assembly import ScatterPlan
from ..ops.local_mv import batched_local_matvec
from ..precond.chebyshev import chebyshev_preconditioner
from ..precond.jacobi import jacobi
from ..precond.twolevel import two_level_preconditioner
from ..solvers.bpcg import bp_scale_factor, bramble_pasciak_cg_opt
from ..solvers.cg import cg
from ..utils.timers import Timer

__all__ = ["NavierStokes"]


class NavierStokes:
    """Taylor-Hood model on triangles or tets.  ``device``: CUDA unless
    the caller passes ``device="cpu"``; ``dtype``: float64 (default) or
    float32.  ``preconditioner``: ``"twolevel"`` (per-component two-level
    additive Schwarz) or ``"jacobi"`` (the diagonal).  ``outflow=""``:
    enclosed flow, the constant pressure deflated from B, B^T and preM."""

    def __init__(self, mesh, nu: float, inflow: str, outflow: str,
                 wall: str, uin, timestep: float, order: int = 2,
                 volumeforce=None, dtype=torch.float64,
                 grad_div: float = 2.0, preconditioner: str = "twolevel",
                 device=None):
        if dtype not in (torch.float64, torch.float32):
            raise TypeError(f"dtype {dtype} is neither float64 nor float32")
        if preconditioner not in ("twolevel", "jacobi"):
            raise ValueError(f"unknown preconditioner {preconditioner!r}: "
                             "'twolevel' or 'jacobi'")
        self.device = dev = resolve_device(device)
        self.preconditioner = preconditioner
        self.nu, self.timestep, self.uin = nu, timestep, uin
        self.inflow, self.outflow, self.wall = inflow, outflow, wall
        self.mesh, self.order, self.dtype = mesh, order, dtype
        self.setup_seconds = {}
        self.last_iterations = {}
        t0 = time.perf_counter()

        d = mesh.dim
        dirichlet = inflow + "|" + wall
        self.V = VectorSpace(H1(mesh, order, dirichlet=dirichlet), d)
        self.Q = H1(mesh, order - 1)
        Vs = self.V.scalar
        self.n = Vs.ndof
        self.d = d

        qd = 2 * order + 1  # exact for the trilinear convection term
        self.tu = asm.make_tables(Vs, qd, dtype, device=dev)
        self.tp = asm.make_tables(self.Q, qd, dtype, device=dev)
        tu = self.tu

        self.K_loc = asm.stiffness_local(tu)
        self.M_loc = asm.mass_local(tu).contiguous()
        self.Mp_loc = asm.mass_local(self.tp)
        self.D_loc = asm.divergence_local(self.tp, tu)
        # grad-div local: dd[e, i, a, j, b] = int d_a(phi_i) d_b(phi_j)
        g = asm.phys_grad(tu)
        self.DD_loc = torch.einsum("q,eqia,eqjb,e->eiajb", tu.qw, g, g,
                                   tu.detj)

        self.free_np = Vs.free_mask
        self.free_s = torch.as_tensor(self.free_np, device=dev)
        self.grad_div = grad_div

        self.f = torch.zeros((d, self.n), dtype=dtype, device=dev)
        if volumeforce is not None:
            self.AddForce(volumeforce)

        u_bc = self.V.interpolate_boundary(self._uin_np, self.inflow)
        self.u_bc = torch.as_tensor(u_bc.reshape(d, self.n),
                                    device=dev).to(dtype)
        self.u = self.u_bc.reshape(-1)
        self.p = torch.zeros(self.Q.ndof, dtype=dtype, device=dev)

        self.stokes_bpcg_iterations = None
        self.stokes_bpcg_time = None
        self.stokes_bpcg_scale_k = None
        self._mass_cheb = None
        self._build_operators()
        self.setup_seconds["operators"] = self._synced(t0)

    # -- reference-API properties ------------------------------------------

    @property
    def velocity(self) -> np.ndarray:
        """(d, n) component-major velocity dof array."""
        return self.u.reshape(self.d, self.n).cpu().numpy()

    @property
    def pressure(self) -> np.ndarray:
        """The reference returns -gfup (NavierStokesSIMPLE_iterative.py:
        163-166)."""
        return -self.p.cpu().numpy()

    # -- operator construction ---------------------------------------------

    def _synced(self, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _uin_np(self, p):
        out = np.asarray(self.uin(p))
        if out.ndim == 1:
            full = np.zeros((len(p), self.d))
            full[:, 0] = out
            return full
        return out

    def _build_operators(self):
        tu, tp = self.tu, self.tp
        n, d, dev = self.n, self.d, self.device
        ne, nb = self.M_loc.shape[:2]
        nQ = self.Q.ndof
        free = self.free_s
        nu, gd, dt = self.nu, self.grad_div, self.timestep
        eld = tu.eldofs

        # the viscous + grad-div table, one square block per element over
        # (i, a) = (basis function, component), component innermost
        eye = torch.eye(d, dtype=self.dtype, device=dev)
        A_tab = nu * self.K_loc[:, :, None, :, None] * eye[None, None, :,
                                                           None, :]
        if gd:
            A_tab = A_tab + gd * nu * self.DD_loc
        self.A_tab = A_tab.reshape(ne, nb * d, nb * d).contiguous()
        # flat dof of (e, i, a): a*n + eldofs[e, i]
        comp = torch.arange(d, device=dev) * n
        idx_ia = (eld[:, :, None] + comp[None, None, :]).reshape(ne, nb * d)
        idx_cei = eld[None, :, :] + comp[:, None, None]  # (d, ne, nb)
        plan_ia = ScatterPlan(idx_ia, d * n)
        plan_c = ScatterPlan(idx_cei, d * n)
        plan_p = ScatterPlan(tp.eldofs, nQ)
        A_tab, M_loc, D_loc = self.A_tab, self.M_loc, self.D_loc

        def stokesA_raw(u2):  # nu*Laplace + gd*nu*grad-div, unmasked
            ue = u2.reshape(-1)[idx_ia]
            return plan_ia(batched_local_matvec(A_tab, ue)).reshape(d, n)

        def mass_raw(u2):
            ue = u2.reshape(-1)[idx_cei]
            y = torch.stack([batched_local_matvec(M_loc, ue[c].contiguous())
                             for c in range(d)])
            return plan_c(y).reshape(d, n)

        def masked(op_raw):
            def op(u):
                u2 = u.reshape(d, n)
                uf = torch.where(free[None], u2, 0.0)
                y = op_raw(uf)
                return torch.where(free[None], y, u2).reshape(-1)

            return op

        self._stokesA_raw = stokesA_raw
        self._mass_raw = mass_raw
        self.A = masked(stokesA_raw)

        def mstar_raw(u2):
            return mass_raw(u2) + dt * stokesA_raw(u2)

        self.mstar = masked(mstar_raw)

        def B_raw(u):
            ue = u.reshape(-1)[idx_cei]  # (d, ne, nb)
            return plan_p(torch.einsum("eijc,cej->ei", D_loc, ue))

        def B(u):
            return B_raw(torch.where(free[None], u.reshape(d, n),
                                     0.0).reshape(-1))

        def BT(p):
            ue = torch.einsum("eijc,ei->cej", D_loc, p[tp.eldofs])
            y = plan_c(ue).reshape(d, n)
            return torch.where(free[None], y, 0.0).reshape(-1)

        self.B, self.B_raw, self.BT = B, B_raw, BT

        # preconditioner diagonals
        diagA = nu * asm.diagonal_of_local(self.K_loc, eld, n)
        if gd:
            dd_diag = torch.einsum("eiaia->eia", self.DD_loc)
            # per-component grad-div diagonal d_a phi_i * d_a phi_i
            diagA_c = torch.stack([
                diagA + gd * nu * asm.scatter_add(dd_diag[:, :, c], eld, n)
                for c in range(d)])
        else:
            diagA_c = diagA[None].expand(d, n)
        diagA_c = torch.where(free[None], diagA_c, 1.0)
        inv_diagA = 1.0 / diagA_c

        if self.preconditioner == "twolevel":
            # per-component two-level additive Schwarz (the reference's
            # MypreA structure: block smoother + order-1 H1 coarse,
            # :310-391)
            K_np = self.K_loc.double().cpu().numpy()
            DD_np = self.DD_loc.double().cpu().numpy()
            pres = []
            for c in range(d):
                a_loc_c = nu * (K_np + (gd * DD_np[:, :, c, :, c]
                                        if gd else 0.0))
                pres.append(two_level_preconditioner(
                    self.V.scalar, a_loc_c, coefficient=nu,
                    smoother="patch", dtype=self.dtype, device=dev))

            def preA(u):
                u2 = u.reshape(d, n)
                return torch.stack([pres[c](u2[c])
                                    for c in range(d)]).reshape(-1)

            # each component's stored patch inverses
            self.preA_tables = [p.table for p in pres]
        else:
            self.preA_tables = []

            def preA(u):
                return (inv_diagA * u.reshape(d, n)).reshape(-1)

        self.preA = preA

        diagM = asm.diagonal_of_local(M_loc, eld, n)
        diagMstar = diagM[None] + dt * diagA_c
        diagMstar = torch.where(free[None], diagMstar, 1.0)
        inv_diagMstar = 1.0 / diagMstar

        def preMstar(u):
            return (inv_diagMstar * u.reshape(d, n)).reshape(-1)

        self.preMstar = preMstar

        # Schur preconditioner: viscosity-scaled pressure-mass Jacobi
        # (S = B A^-1 B^T ~ (1/nu) M_p for the viscous block)
        diag_Mp = asm.diagonal_of_local(self.Mp_loc, tp.eldofs, nQ)
        preM_unit = jacobi(diag_Mp)
        if not self.outflow:
            # enclosed flow (e.g. the lid-driven cavity): pressure is
            # defined up to a constant -- deflate it from the Schur block
            def demean(p):
                return p - torch.mean(p)

            B_enc, BT_enc = B, BT
            self.B = lambda u: demean(B_enc(u))
            self.B_raw = lambda u: demean(B_raw(u))
            self.BT = lambda p: BT_enc(demean(p))
            self.preM = lambda p: nu * demean(preM_unit(demean(p)))
        else:
            self.preM = lambda p: nu * preM_unit(p)

        # velocity mass (masked) + its Jacobi, for the projection Schur solve
        self.Mv = masked(mass_raw)
        diagMv = torch.where(free[None], diagM[None].expand(d, n), 1.0)
        inv_diagMv = 1.0 / diagMv
        self.preMv = lambda u: (inv_diagMv * u.reshape(d, n)).reshape(-1)

        # convection: matrix-free -(u . grad)u . v at quadrature points
        val = tu.val
        gphys = asm.phys_grad(tu)  # (ne, nq, nb, d)
        w_e = tu.qw[None, :] * tu.detj[:, None]  # (ne, nq)

        def convection(u):
            ue = u.reshape(-1)[idx_cei]  # (d, ne, nb)
            uq = torch.einsum("qi,cei->ceq", val, ue)  # values at quad pts
            gq = torch.einsum("eqia,cei->ceqa", gphys, ue)  # grad u
            conv_q = torch.einsum("aeq,ceqa->ceq", uq, gq)  # (u . grad) u
            fe = -torch.einsum("eq,ceq,qi->cei", w_e, conv_q, val)
            return plan_c(fe)

        self.convection = convection

    # -- reference API ------------------------------------------------------

    def load_state(self, u=None, p=None, cheb_bounds=None):
        """Take up another model's state, given as numpy: the flat (d*n,)
        velocity, the pressure and the (alpha, beta) bounds of its
        Chebyshev mass inverse (which then replace the Lanczos estimate)."""
        if u is not None:
            u = np.array(u).reshape(-1)
            if u.shape != (self.d * self.n,):
                raise ValueError(f"u of shape {u.shape}, expected "
                                 f"{(self.d * self.n,)}")
            self.u = torch.as_tensor(u, device=self.device).to(self.dtype)
        if p is not None:
            p = np.array(p)
            if p.shape != (self.Q.ndof,):
                raise ValueError(
                    f"p of shape {p.shape}, expected {(self.Q.ndof,)}")
            self.p = torch.as_tensor(p, device=self.device).to(self.dtype)
        if cheb_bounds is not None:
            self._mass_cheb = None
            self._mass_chebyshev(bounds=tuple(float(b) for b in cheb_bounds))

    def AddForce(self, force):
        """Accumulate integral force . v into the rhs (reference :422-425).
        ``force``: callable points (n, dim) -> (n, dim)."""
        tu = self.tu
        qpts = tu.qpts.cpu().numpy()
        fq = np.asarray(force(qpts.reshape(-1, self.d))).reshape(
            qpts.shape[0], qpts.shape[1], self.d)
        fq = torch.as_tensor(fq, device=self.device).to(self.dtype)
        comps = [asm.scatter_add(asm.linear_form_local(tu, fq[:, :, c]),
                                 tu.eldofs, self.n) for c in range(self.d)]
        self.f = self.f + torch.stack(comps)

    def SolveInitial(self, timesteps=None, iterative: bool = True,
                     GS: bool = True, tol: float = 1e-10,
                     maxsteps: int = 100000, scale_k=None):
        """Steady Stokes solve (``timesteps`` None) or the projection
        time-stepping warmup (reference :168-420).  The solve is BPCG v2 in
        the model's precision; ``scale_k``: the Bramble-Pasciak scaling,
        from Lanczos when None.  ``GS`` only tags the call, as in the JAX
        model (its preconditioner has no GS variant).  Sets ``u``, ``p``,
        ``stokes_bpcg_iterations``, ``stokes_bpcg_time`` and
        ``stokes_bpcg_scale_k`` and returns the solver's result."""
        d, n = self.d, self.n
        if timesteps:
            self.Project()
            for _ in range(timesteps):
                temp = torch.where(
                    self.free_s[None],
                    -self._stokesA_raw(self.u.reshape(d, n)), 0.0,
                ).reshape(-1)
                temp2, _ = self._project_velocity(self._inv_mstar(temp))
                self.u = self.u + self.timestep * temp2
                self.Project()
            return None

        timer = Timer("stokes-bpcg").Start()
        u_bc = self.u_bc.reshape(-1)
        f_mod = torch.where(self.free_s[None],
                            self.f - self._stokesA_raw(self.u_bc),
                            0.0).reshape(-1)
        g_mod = -self.B_raw(u_bc)
        if scale_k is None:
            scale_k, _ = bp_scale_factor(self.A, self.preA, f_mod)
        res = bramble_pasciak_cg_opt(
            self.A, self.B, self.BT, self.preA, self.preM, f_mod, g_mod,
            tol=tol, maxsteps=maxsteps, rel_err=True, scale_k=scale_k)
        timer.Stop(res.x)
        self.u = u_bc + res.x[0]
        self.p = res.x[1]
        self.stokes_bpcg_iterations = int(res.iterations)
        self.stokes_bpcg_time = timer.time
        self.stokes_bpcg_scale_k = float(scale_k)
        return res

    def _inv_mstar(self, rhs, precision: float = 1e-4, maxsteps: int = 2000):
        """CG inverse of mstar at the reference's precision 1e-4 (:93)."""
        res = cg(self.mstar, rhs, pre=self.preMstar, tol=precision,
                 maxsteps=maxsteps)
        self.last_iterations["mstar"] = res.iterations
        return res.x

    def _mass_chebyshev(self, degree: int = 16, bounds=None):
        """Fixed-degree Chebyshev approximation of Mv^{-1} (linear, SPD),
        built once; ``bounds`` (alpha, beta) replace the Lanczos
        estimate."""
        if self._mass_cheb is None:
            t0 = time.perf_counter()
            self._mass_cheb = chebyshev_preconditioner(
                self.Mv, self.preMv, self.u_bc.reshape(-1), degree=degree,
                bounds=bounds, lower_fraction=0.02)
            self.setup_seconds["mass chebyshev"] = self._synced(t0)
        return self._mass_cheb

    def _project_velocity(self, u, tol: float = 1e-8, maxsteps: int = 500):
        """(u - M~^-1 B^T p, p) with (B M~^-1 B^T) p = B u; the inner mass
        inverse is the fixed-degree Chebyshev polynomial, so the projection
        is exactly divergence-free for the SPD operator it defines."""
        Minv = self._mass_chebyshev()

        def S(p):
            return self.B(Minv(self.BT(p)))

        # the UNmasked divergence, so that the projected total velocity
        # (its Dirichlet part included) is discretely divergence-free
        rhs = self.B_raw(u)
        pres = cg(S, rhs, pre=self.preM, tol=tol, maxsteps=maxsteps)
        self.last_iterations["project"] = pres.iterations
        return u - Minv(self.BT(pres.x)), pres.x

    def Project(self, vel=None):
        """Divergence-free projection; also extracts the pressure into the
        state like the reference (:441-443).  With no argument, projects the
        velocity state in place; with ``vel``, returns the projected
        vector."""
        if vel is None:
            self.u, self.p = self._project_velocity(self.u)
            return None
        u_new, self.p = self._project_velocity(vel)
        return u_new

    def make_step_fn(self, project_tol: float = 1e-8,
                     mstar_tol: float = 1e-4):
        """The IMEX step u -> u_next (the DoTimeStep body): explicit
        convection, the inner M* CG at ``mstar_tol``, the Schur projection
        CG at ``project_tol`` (the JAX model's 1e-8; an f32 model needs a
        reachable one, ~1e-5).  The Chebyshev bounds are taken here."""
        self._mass_chebyshev()
        free, f, dt, d, n = self.free_s, self.f, self.timestep, self.d, self.n
        convection, stokesA_raw = self.convection, self._stokesA_raw
        inv_mstar, project = self._inv_mstar, self._project_velocity

        def step(u):
            u2 = u.reshape(d, n)
            temp = convection(u).reshape(d, n) + f - stokesA_raw(u2)
            temp = torch.where(free[None], temp, 0.0).reshape(-1)
            temp2, _ = project(inv_mstar(temp, precision=mstar_tol),
                               tol=project_tol)
            return u + dt * temp2

        return step

    def DoTimeStep(self):
        """One IMEX step (reference :427-438)."""
        if getattr(self, "_step", None) is None:
            self._step = self.make_step_fn()
        self.u = self._step(self.u)

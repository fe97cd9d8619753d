"""The two discretizations of the DFG 3D channel with cylinder, assembled
by the reference, and what the benchmark compares with them.

``mcs3d_host`` / ``hdg3d_host`` build the host tables (f64 numpy, the
frozen assembly), independent of the inflow speed; ``StokesReference``
ships them to a device in a chosen precision and measures the true
relative residual of a Stokes state; ``SimpleReference`` adds the upwind
convection and the Chebyshev mass inverse and takes one SIMPLE step

    u -> u + dt P(M*^-1 (conv(u) + f - A u)),
    P w = w - Minv B^T S^-1 B w,  S = B Minv B^T,

with every inner solve run to a tight tolerance, so that the step is the
one the configuration defines and not one iteration count of it.
"""

from __future__ import annotations

import numpy as np
import torch

from .assembly import (
    HDiv3D,
    HybridVelocitySpace3D,
    L2,
    VectorFacet3D,
    _assemble_mcs_ns_local_3d,
    _assemble_mcs_ns_local_curved_3d,
    assemble_hdg_stokes_3d,
    free_blocks,
    interpolate_hybrid_boundary_3d,
)
from .convection import build_upwind_convection_3d
from .fem.hcurldiv3d import hcurldiv_tet
from .linalg import ElementOp, cg, chebyshev_inverse, lanczos_max
from .mesh.curved import curve_to_cylinder_3d
from .mesh.generators import channel_with_cylinder_mesh_3d

__all__ = ["H", "inflow", "mcs3d_host", "hdg3d_host", "StokesReference",
           "SimpleReference"]

H = 0.41
INFLOW, OUTFLOW, WALL = "inlet", "outlet", "wall|cyl"
DIRICHLET = INFLOW + "|" + WALL


def inflow(um: float):
    """The DFG 3D inflow 16 Um y z (H - y)(H - z) / H^4 in x."""
    def uin(p):
        p = np.asarray(p)
        out = np.zeros((len(p), 3))
        out[:, 0] = (um * 16 * p[:, 1] * (H - p[:, 1]) * p[:, 2]
                     * (H - p[:, 2]) / H**4)
        return out
    return uin


def mcs3d_host(maxh: float, order: int, nu: float, curved: bool) -> dict:
    """Host tables of the order-``order`` MCS discretization: the condensed
    [H(div) | facet] operator A, the velocity mass M and the divergence
    coupling B per element, with the spaces they live on."""
    mesh = channel_with_cylinder_mesh_3d(maxh)
    geometry = (curve_to_cylinder_3d(mesh, "cyl", (0.5, 0.2), 0.05, order=3)
                if curved else None)
    V = HDiv3D(mesh, order, dirichlet=DIRICHLET)
    Vhat = VectorFacet3D(mesh, order - 1, dirichlet=DIRICHLET + "|" + OUTFLOW)
    Xv = HybridVelocitySpace3D(V, Vhat)
    sigma = hcurldiv_tet(order, order_trace=order - 1)
    Wq, Q = L2(mesh, order - 1), L2(mesh, order - 1)
    tabs = _assemble_mcs_ns_local_3d(mesh, V, Vhat, sigma, Wq.basis, Q.basis,
                                     nu)
    if geometry is not None:
        _assemble_mcs_ns_local_curved_3d(V, Vhat, sigma, Wq.basis, Q.basis,
                                         nu, geometry, *tabs)
    A_ret, A_rc, A_cc, M, B = tabs
    A = A_ret - np.einsum("eic,ecd,ejd->eij", A_rc, np.linalg.inv(A_cc),
                          A_rc, optimize=True)
    return dict(mesh=mesh, V=V, Xv=Xv, Q=Q, A=A, M=M, B=B)


def hdg3d_host(maxh: float, order: int, nu: float, alpha: float = 10.0
               ) -> dict:
    """Host tables of the order-``order`` HDG discretization (BDM_k x
    facet_k x P_{k-1} dc, interior penalty ``alpha``) on the straight
    channel."""
    mesh = channel_with_cylinder_mesh_3d(maxh)
    V = HDiv3D(mesh, order, dirichlet=DIRICHLET)
    F = VectorFacet3D(mesh, order, dirichlet=DIRICHLET)
    Xv = HybridVelocitySpace3D(V, F)
    Q = L2(mesh, order - 1)
    A, B, _, _, _ = assemble_hdg_stokes_3d(Xv, Q, alpha=alpha, nu=nu)
    return dict(mesh=mesh, V=V, Xv=Xv, Q=Q, A=A, B=B)


def star_widths(host: dict) -> np.ndarray:
    """Free-dof widths of the vertex-star blocks of the hybrid space."""
    return np.array([len(b) for b in free_blocks(host["Xv"], "vertexstar")])


class StokesReference:
    """The Stokes operators of ``host`` on ``device`` in ``dtype``, with the
    boundary data of inflow speed ``um``."""

    def __init__(self, host: dict, um: float, dtype=torch.float64,
                 device="cpu"):
        Xv, Q = host["Xv"], host["Q"]
        self.dtype, self.device = dtype, device
        self.n, self.nq = Xv.ndof, Q.ndof
        el, elp = Xv.element_dofs, Q.element_dofs
        self.A = ElementOp(host["A"], el, el, self.n, dtype, device)
        self.B = ElementOp(host["B"], elp, el, self.nq, dtype, device)
        self.BT = ElementOp(host["B"].transpose(0, 2, 1), el, elp, self.n,
                            dtype, device)
        self.free = torch.as_tensor(Xv.free_mask, device=device)
        u_bc = interpolate_hybrid_boundary_3d(Xv, inflow(um), INFLOW)
        self.u_bc = torch.as_tensor(u_bc, device=device).to(dtype)
        self.f = torch.zeros(self.n, dtype=dtype, device=device)

    def true_rel(self, u, p) -> float:
        """|| K (u, p) - (f, 0) || / || the right-hand side of the
        homogeneous problem ||, Dirichlet rows read as u - u_bc."""
        u = torch.as_tensor(u, device=self.device).to(self.dtype)
        p = torch.as_tensor(p, device=self.device).to(self.dtype)
        free = self.free
        r0 = torch.where(free, self.f - self.A(u) - self.BT(p),
                         self.u_bc - u)
        r1 = -self.B(u)
        f_mod = torch.where(free, self.f - self.A(self.u_bc), 0.0)
        g_mod = -self.B(self.u_bc)
        num = torch.sqrt(torch.sum(r0.double() ** 2)
                         + torch.sum(r1.double() ** 2))
        den = torch.sqrt(torch.sum(f_mod.double() ** 2)
                         + torch.sum(g_mod.double() ** 2))
        return float(num / den)


class SimpleReference(StokesReference):
    """One SIMPLE step of the MCS model at time step ``dt``: the upwind
    convection, M* = M + dt A solved by Jacobi-preconditioned CG, and the
    projection with the degree-16 Chebyshev mass inverse on
    [0.02 beta, beta], beta 1.05 times the largest Ritz value of 30 Lanczos
    steps from a standard normal vector drawn from seed 0.  The bounds are
    always worked out in float64; ``dtype`` is the precision of the step."""

    CHEB_DEGREE, LANCZOS_STEPS, LOWER_FRACTION = 16, 30, 0.02

    def __init__(self, host: dict, um: float, dt: float,
                 dtype=torch.float64, device="cpu", tol: float = 1e-11,
                 maxsteps: int = 5000):
        super().__init__(host, um, dtype, device)
        self.dt, self.tol, self.maxsteps = dt, tol, maxsteps
        Xv, V = host["Xv"], host["V"]
        el = Xv.element_dofs
        self.M = ElementOp(host["M"], el, el, self.n, dtype, device)
        self.nv = V.ndof
        self.conv = build_upwind_convection_3d(V, inflow(um), dtype=dtype,
                                               device=device)
        free = self.free
        n = self.n

        def diag(table):
            d = np.zeros(n)
            np.add.at(d, el.ravel(), np.einsum("eii->ei", table).ravel())
            return torch.as_tensor(d, device=device)

        d_star = diag(host["M"] + dt * host["A"]).abs()
        d_star = torch.where(free, d_star, 1.0).to(dtype)
        self.pre_star = lambda u: torch.where(free, u / d_star, u)
        d_mv = diag(host["M"])
        d_mv = torch.where(free & (d_mv.abs() > 1e-30), d_mv, 1.0)
        fu = free & (torch.arange(n, device=device) < self.nv)
        self._fu = fu

        def Mv(u):
            return torch.where(fu, self.M(torch.where(fu, u, 0.0)), u)

        self.Mv = Mv
        self.pre_mv = lambda u: torch.where(free, u / d_mv.to(u.dtype), u)
        # the Chebyshev bounds, in float64 whatever the step's precision
        M64 = ElementOp(host["M"], el, el, n, torch.float64, device)
        d_mv64 = d_mv.to(torch.float64)

        def Mv64(u):
            return torch.where(fu, M64(torch.where(fu, u, 0.0)), u)

        v0 = torch.randn(n, generator=torch.Generator().manual_seed(0),
                         dtype=torch.float64)
        lam = lanczos_max(Mv64, lambda u: torch.where(free, u / d_mv64, u),
                          n, self.LANCZOS_STEPS, v0, torch.float64, device)
        self.beta = 1.05 * lam
        self.alpha = self.LOWER_FRACTION * self.beta
        self.Minv = chebyshev_inverse(Mv, self.pre_mv, self.alpha, self.beta,
                                      self.CHEB_DEGREE)
        # element-block Jacobi of S: the element Schur blocks inverted
        B, Mh = host["B"], host["M"]
        S_blk = np.einsum("epi,eij,eqj->epq", B,
                          np.linalg.pinv(Mh, rcond=1e-10), B, optimize=True)
        elp = host["Q"].element_dofs
        self.pre_S = ElementOp(np.linalg.pinv(S_blk, rcond=1e-8), elp, elp,
                               self.nq, dtype, device)

    def mstar(self, u):
        free = self.free
        uf = torch.where(free, u, 0.0)
        return torch.where(free, self.M(uf) + self.dt * self.A(uf), u)

    def step(self, u):
        """The step from state ``u``; returns (u_next, M* CG iterations,
        projection CG iterations)."""
        u = torch.as_tensor(u, device=self.device).to(self.dtype)
        free = self.free
        cv = torch.cat([self.conv(u[: self.nv]), u.new_zeros(self.n - self.nv)])
        rhs = torch.where(free, cv + self.f - self.A(u), 0.0)
        w, k_m = cg(self.mstar, rhs, self.pre_star, self.tol, self.maxsteps)

        def BT(p):
            return torch.where(free, self.BT(p), 0.0)

        def S(p):
            return self.B(torch.where(free, self.Minv(BT(p)), 0.0))

        p, k_p = cg(S, self.B(w), self.pre_S, self.tol, self.maxsteps)
        w = w - self.Minv(BT(p))
        return u + self.dt * w, k_m, k_p

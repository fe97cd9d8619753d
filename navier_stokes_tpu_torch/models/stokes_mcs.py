"""MCS (mass-conserving mixed stress) Stokes: the 3-field H(div) x
H(curl,div) x L2 formulation.

Counterpart of ``navier_stokes_tpu/models/stokes_mcs.py`` (the reference's
``solve_hcurldiv`` family and standalone script, run.py:175-215 and
stokes_hcurldiv.py): find (u, sigma, p) with

  a((u,s,p),(v,t,q)) = int s:t
                     + int (div s . v + div t . u)
                     - sum_T int_dT (s n.n)(v.n) + (t n.n)(u.n)
                     + int (div u q + div v p)

u in RT_k/BDM_k (Piola), sigma in HCurlDiv_k (nt-continuous,
sigma = J^{-T} sigmahat J^T / detJ), p in discontinuous P_k.  Tangential
velocity continuity is imposed weakly through sigma -- no facet space and
no penalty.

The element blocks over the combined [u | sigma | p] dofs are assembled on
the host in f64 as the JAX package's.  The reference solves the system with
a sparse direct factorization (UMFPACK, run.py:205): ``solve_mcs_direct``
is scipy's ``spsolve`` on the host, in both packages.  ``solve_mcs_minres``
is the device path: Jacobi-preconditioned MINRES whose operator applies the
element blocks through the batched local matvec kernel (one launch per
apply on the card).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..fem.hcurldiv import HCurlDiv, HCurlDivSpace
from ..fem.hdiv import HDiv, HDivSpace, legendre_01
from ..fem.quadrature import gauss_legendre_01, triangle_rule
from ..fem.spaces import L2, FunctionSpace
from ..ops import assembly as asm
from ..ops.facets import facet_geometry
from ..utils.timers import Timer
from .stokes import default_volume_force

__all__ = ["MCSSystem", "assemble_mcs_stokes", "mcs_discretization",
           "solve_hcurldiv", "solve_mcs_direct", "solve_mcs_minres"]


@dataclass
class MCSSystem:
    V: HDivSpace
    S: HCurlDivSpace
    Q: FunctionSpace
    A_loc: np.ndarray  # (ne, nloc, nloc) signs folded
    eldofs: np.ndarray  # (ne, nloc) combined
    f: np.ndarray  # (ndof,) rhs with BC lifting applied
    u_bc: np.ndarray  # (ndof,) boundary lifting
    free: np.ndarray  # (ndof,) bool
    ndofs: int

    @property
    def offsets(self):
        return self.V.ndof, self.V.ndof + self.S.ndof


def assemble_mcs_stokes(
    mesh,
    V: HDivSpace,
    S: HCurlDivSpace,
    Q: FunctionSpace,
    volume_force=default_volume_force,
    uin=None,
):
    hb, sb, qb = V.basis, S.basis, Q.basis
    k = max(hb.order, sb.order, Q.order)
    nbv, nbs, nbq = hb.n_basis, sb.n_basis, qb.n_basis
    nloc = nbv + nbs + nbq

    J, detJ, Jinv = mesh.element_jacobians
    vol = triangle_rule(2 * k + 2)
    ne = mesh.ne

    # reference tabulations
    v_val, v_grad = hb.tabulate(vol.points)  # (nq,nbv,2), (nq,nbv,2,2)
    s_val, s_grad = sb.tabulate(vol.points)  # (nq,nbs,2,2), (+,2)
    q_val, _ = qb.tabulate(vol.points)  # (nq,nbq)
    w = vol.weights

    # physical sigma: (1/detJ) J^{-T} shat J^T ; J^{-T}_{ia} = Jinv[a,i]
    sp = np.einsum("eai,qnab,ejb->eqnij", Jinv, s_val, J,
                   optimize=True) / detJ[:, None, None, None, None]
    # reference divergences
    # d_b shat_ab
    div_s_ref = np.einsum("qnabb->qna", s_grad[..., :, :], optimize=True)
    div_v_ref = np.einsum("qnaa->qn", v_grad)

    A = np.zeros((ne, nloc, nloc))
    sl = slice(nbv, nbv + nbs)
    ql = slice(nbv + nbs, nloc)
    vl = slice(0, nbv)

    # int sigma : tau
    A[:, sl, sl] += np.einsum("q,eqnij,eqmij,e->enm", w, sp, sp, detJ,
                              optimize=True)
    # int div(sigma).v + div(tau).u : pairing reduces to ref frame / detJ
    dsv = np.einsum("q,qna,qma,e->enm", w, div_s_ref, v_val, 1.0 / detJ,
                    optimize=True)
    A[:, sl, vl] += dsv
    A[:, vl, sl] += dsv.transpose(0, 2, 1)
    # int div(u) q + div(v) p
    duq = np.einsum("q,qn,qm,e->enm", w, q_val, div_v_ref, np.ones(ne),
                    optimize=True)
    A[:, ql, vl] += duq
    A[:, vl, ql] += duq.transpose(0, 2, 1)

    # facet terms: - (sigma n . n)(v . n)
    fg = facet_geometry(mesh, k + 3)
    for le in range(3):
        pts = fg.ref_points[le]
        tv, _ = hb.tabulate(pts)
        ts, _ = sb.tabulate(pts)
        v_p = np.einsum("ecA,qiA->eqic", J, tv,
                        optimize=True) / detJ[:, None, None, None]
        s_p = np.einsum("eai,qnab,ejb->eqnij", Jinv, ts, J,
                        optimize=True) / detJ[:, None, None, None, None]
        n = fg.normal[:, le]
        vn = np.einsum("eqic,ec->eqi", v_p, n, optimize=True)
        snn = np.einsum("eqnij,ei,ej->eqn", s_p, n, n, optimize=True)
        ds = fg.elen[:, le]
        blk = np.einsum("q,eqn,eqm,e->enm", fg.w, snn, vn, ds, optimize=True)
        A[:, sl, vl] -= blk
        A[:, vl, sl] -= blk.transpose(0, 2, 1)

    # combined dof table + signs
    eldofs = np.concatenate(
        [
            V.element_dofs,
            V.ndof + S.element_dofs,
            V.ndof + S.ndof + Q.element_dofs,
        ],
        axis=1,
    )
    signs = np.concatenate(
        [V.element_signs, S.element_signs, np.ones((ne, nbq))], axis=1
    )
    A = A * signs[:, :, None] * signs[:, None, :]

    # rhs: int f . v (velocity block only)
    qpts = mesh.points[mesh.elements[:, 0]][:, None, :] + np.einsum(
        "eab,qb->eqa", J, vol.points, optimize=True)
    fq = volume_force(qpts.reshape(-1, 2)).reshape(ne, -1, 2)
    v_p_vol = np.einsum("ecA,qiA->eqic", J, v_val,
                        optimize=True) / detJ[:, None, None, None]
    fe = np.zeros((ne, nloc))
    fe[:, vl] = np.einsum("q,eqc,eqic,e->ei", w, fq, v_p_vol, detJ,
                          optimize=True)
    fe = fe * signs
    ndofs = V.ndof + S.ndof + Q.ndof
    fvec = np.zeros(ndofs)
    np.add.at(fvec, eldofs.ravel(), fe.ravel())

    # boundary lifting (inlet velocity on the HDiv normal moments)
    u_bc = np.zeros(ndofs)
    if uin is not None:
        t, wq = gauss_legendre_01(8)
        fids = mesh.boundary_facet_ids("inlet")
        ev = mesh.points[mesh.edges[fids]]
        pa, pb = ev[:, 0], ev[:, 1]
        pts_b = pa[:, None, :] + t[None, :, None] * (pb - pa)[:, None, :]
        vals = uin(pts_b.reshape(-1, 2)).reshape(len(fids), len(t), 2)
        dvec = pb - pa
        nvec = np.stack([dvec[:, 1], -dvec[:, 0]], axis=1)
        for j in range(hb.n_edge):
            Lj = legendre_01(t, j)
            u_bc[fids * hb.n_edge + j] = np.einsum(
                "q,bqc,bc,q->b", wq, vals, nvec, Lj, optimize=True)

    free = np.concatenate([V.free_mask, S.free_mask, Q.free_mask])
    return MCSSystem(
        V=V, S=S, Q=Q, A_loc=A, eldofs=eldofs.astype(np.int32),
        f=fvec, u_bc=u_bc, free=free, ndofs=ndofs,
    )


def solve_mcs_direct(system: MCSSystem):
    """Sparse direct solve on free dofs (the UMFPACK path, run.py:201-207):
    scipy on the host, as in the JAX package.  Returns (x, seconds)."""
    import scipy.sparse.linalg as spla

    timer = Timer("Direct Solver").Start()
    K = asm.assemble_csr(system.A_loc, system.eldofs, system.ndofs)
    res = system.f - K @ system.u_bc
    idx = np.where(system.free)[0]
    sol = np.zeros(system.ndofs)
    sol[idx] = spla.spsolve(K[idx][:, idx].tocsc(), res[idx])
    x = system.u_bc + sol
    timer.Stop()
    return x, timer.time


def solve_mcs_minres(system: MCSSystem, tol=1e-9, maxsteps=20000,
                     dtype=torch.float64, device=None):
    """Device path: block-diagonally preconditioned MINRES on the symmetric
    indefinite MCS system.  Returns (x as numpy, the MINRES result)."""
    from ..solvers.minres import minres

    device = resolve_device(device)
    A_loc = torch.as_tensor(system.A_loc, device=device).to(dtype)
    A_loc = A_loc.contiguous()
    eldofs = torch.as_tensor(system.eldofs.astype(np.int64), device=device)
    plan = asm.ScatterPlan(eldofs, system.ndofs)
    free = torch.as_tensor(system.free, device=device)
    n = system.ndofs

    def K(x):
        xf = torch.where(free, x, 0.0)
        y = asm.apply_local_matrices(A_loc, plan, n, xf, use_kernel=True)
        return torch.where(free, y, x)

    diag = asm.diagonal_of_local(A_loc, plan, n)
    diag = torch.where(free, torch.abs(diag), 1.0)
    # velocity block of the MCS matrix has zero diagonal (pure constraint
    # coupling): fall back to a mass-scale there
    diag = torch.where(diag < 1e-30, 1.0, diag)

    def pre(x):
        return torch.where(free, x / diag, x)

    u_bc = torch.as_tensor(system.u_bc, device=device).to(dtype)
    rhs_np = system.f - asm.apply_local_matrices(
        A_loc, plan, n, u_bc, use_kernel=True).cpu().numpy()
    rhs = torch.where(free, torch.as_tensor(rhs_np, device=device).to(dtype),
                      0.0)
    res = minres(K, rhs, pre=pre, tol=tol, maxsteps=maxsteps)
    x = u_bc + res.x
    return x.cpu().numpy(), res


def solve_hcurldiv(mesh, discretization, solver_factory=None, uin=None,
                   volume_force=default_volume_force):
    """run.py:175-215 equivalent driver: returns
    (velocity_dofs, pressure_dofs, errors, time, ndofs)."""
    from .stokes import default_inlet_profile

    if uin is None:
        uin = default_inlet_profile()
    V, S, Q = discretization(
        mesh, velocity_dirichlet="wall|inlet|cyl", velocity_neumann="outlet"
    )
    system = assemble_mcs_stokes(mesh, V, S, Q, volume_force, uin)
    x, time = solve_mcs_direct(system)
    o1, o2 = system.offsets
    return x[:o1], x[o2:], [], time, system.ndofs


def mcs_discretization(order: int, raviart_thomas: bool = True):
    """The hcurldiv catalog entry (discretizations.py:81-88)."""

    def discretization(mesh, velocity_dirichlet, velocity_neumann):
        V = HDiv(mesh, order, dirichlet=velocity_dirichlet,
                 RT=raviart_thomas)
        S = HCurlDiv(mesh, order, dirichlet=velocity_neumann)
        Q = L2(mesh, order)
        return V, S, Q

    return (discretization, order)

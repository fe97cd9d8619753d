"""2D hybrid [H(div) | tangential facet] velocity space and its
A-preconditioners.

Counterpart of the parts of ``navier_stokes_tpu/models/stokes_hybrid.py``
that the 2D MCS Navier-Stokes model needs: the combined velocity space
(the reference's FESpace([V, Vhat]), discretizations.py:66), the Dirichlet
boundary interpolation onto normal and tangential edge moments (pure
numpy), the vector-P1 embedding of the auxiliary-space coarse correction,
the smoother blocks (per edge and cell, or overlapping vertex stars) and
``build_hybrid_preconditioner`` with its four ``a_pre`` variants, additive
or as a symmetric multicolor block Gauss-Seidel (the reference's MypreA,
NavierStokesSIMPLE_iterative.py:211-391).

Host setup is numpy in f64, as the JAX package's; the applies are torch on
``device``.  The block inverses go through the hand-written kernels
(precond/jacobi.block_jacobi and precond/multicolor.MulticolorGS: f64 blocks
through ``batched_local_matvec``), every scatter is a deterministic
``ScatterPlan``, and the P1 embedding T and its transpose are padded-ELL
gathers of the host-assembled sparse T (precond/amg._ell), the same linear
maps as the JAX package's ``.at[].set`` / ``.at[].add`` forms.

The HDG Stokes assembly and ``build_hybrid_stokes_system`` of the same JAX
module belong to the Stokes catalog and are not here.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from ..fem.hdiv import HDivSpace, TangentialFacetSpace, legendre_01
from ..fem.quadrature import gauss_legendre_01, triangle_rule
from ..fem.spaces import H1
from ..ops.assembly import diagonal_of_local
from ..precond.amg import _ell, _ell_apply
from ..precond.jacobi import block_jacobi, extract_blocks_from_local
from ..precond.multicolor import (
    MulticolorGS,
    color_blocks,
    damped_coarse,
    symmetric_gs_preconditioner,
)
from ..precond.twolevel import coarse_p1_solver

__all__ = ["HybridVelocitySpace", "interpolate_hybrid_boundary",
           "hybrid_h1_embedding", "hybrid_blocks",
           "build_hybrid_preconditioner", "A_PRECONDITIONERS"]

A_PRECONDITIONERS = ("jacobi", "edgeblock", "vertexstar", "auxspace")


@dataclass
class HybridVelocitySpace:
    """Combined [HDiv | tangential facet] velocity space
    (the reference's FESpace([V, Vhat]), discretizations.py:66)."""

    hdiv: HDivSpace
    facet: TangentialFacetSpace

    @property
    def mesh(self):
        return self.hdiv.mesh

    @property
    def ndof(self) -> int:
        return self.hdiv.ndof + self.facet.ndof

    @property
    def order(self) -> int:
        return self.hdiv.order

    @cached_property
    def free_mask(self) -> np.ndarray:
        return np.concatenate([self.hdiv.free_mask, self.facet.free_mask])

    @cached_property
    def element_dofs(self) -> np.ndarray:
        """(ne, nb_v + 3*nf) combined dof table."""
        mesh = self.mesh
        nfd = self.facet.n_edge
        fac = np.zeros((mesh.ne, 3 * nfd), dtype=np.int32)
        for le in range(3):
            base = self.hdiv.ndof + mesh.element_edges[:, le] * nfd
            for j in range(nfd):
                fac[:, le * nfd + j] = base + j
        return np.concatenate([self.hdiv.element_dofs, fac], axis=1)

    @cached_property
    def element_signs(self) -> np.ndarray:
        signs_f = np.ones((self.mesh.ne, 3 * self.facet.n_edge))
        return np.concatenate([self.hdiv.element_signs, signs_f], axis=1)


def interpolate_hybrid_boundary(V: HybridVelocitySpace, uin, names: str,
                                nq1: int = 8) -> np.ndarray:
    """Boundary interpolation of a velocity field onto (normal moments,
    tangential facet moments) of the named edges -- the GridFunction.Set
    equivalent for the hybrid pair (run.py:162-164)."""
    mesh = V.mesh
    t, w = gauss_legendre_01(nq1)
    u = np.zeros(V.ndof)
    ne_d, nf_d = V.hdiv.basis.n_edge, V.facet.n_edge
    fids = mesh.boundary_facet_ids(names)
    ev = mesh.points[mesh.edges[fids]]  # (nb, 2, 2)
    pa, pb = ev[:, 0], ev[:, 1]
    # quad points along the global direction
    pts = pa[:, None, :] + t[None, :, None] * (pb - pa)[:, None, :]
    vals = uin(pts.reshape(-1, 2)).reshape(len(fids), nq1, 2)
    dvec = pb - pa  # scaled tangent (length = edge length)
    nvec = np.stack([dvec[:, 1], -dvec[:, 0]], axis=1)  # scaled normal
    tau_unit = dvec / np.linalg.norm(dvec, axis=1, keepdims=True)
    for j in range(max(ne_d, nf_d)):
        Lj = legendre_01(t, j)
        if j < ne_d:
            # c = int (u . n_scaled) L_j dt  (Piola-invariant moment)
            mom = np.einsum("q,bqc,bc,q->b", w, vals, nvec, Lj, optimize=True)
            u[fids * ne_d + j] = mom
        if j < nf_d:
            mom = np.einsum("q,bqc,bc,q->b", w, vals, tau_unit, Lj,
                            optimize=True)
            u[V.hdiv.ndof + fids * nf_d + j] = mom
    return u


def hybrid_h1_embedding(V: HybridVelocitySpace, dtype=torch.float64,
                        interior: bool = True, device=None):
    """(T, TT): embed a vector P1 field, (2*nv,) component-major, into the
    hybrid dofs, and the exact transpose.

    Edge dofs: normal/tangential moments (exact for linears).  Interior
    dofs (``interior=True``): per-element L2-best completion given the edge
    moments -- the role of the reference's facet-block ``einv`` transfer
    solve (NavierStokesSIMPLE_iterative.py:249-291): without it the
    embedded function's tangential trace is uncontrolled and the HDG
    penalty term destroys the auxiliary-space stability.  Vector linears
    are reproduced exactly.  T has at most 6 entries per fine row, so both
    directions are padded-ELL gathers with row sums."""
    device = resolve_device(device)
    mesh = V.mesh
    ne_d, nf_d = V.hdiv.basis.n_edge, V.facet.n_edge
    ev = mesh.points[mesh.edges]
    dvec = ev[:, 1] - ev[:, 0]
    nvec = np.stack([dvec[:, 1], -dvec[:, 0]], axis=1)  # scaled normal
    tau = dvec / np.linalg.norm(dvec, axis=1, keepdims=True)
    # int (1-t) L_j dt, int t L_j dt for orthonormal Legendre on [0,1]
    c0 = np.array([0.5, -np.sqrt(3.0) / 6.0])  # weight of endpoint a, j=0,1
    c1 = np.array([0.5, np.sqrt(3.0) / 6.0])
    nV = V.ndof
    nv = mesh.nv
    nedge = mesh.nedge
    nhd = V.hdiv.ndof
    njmax = min(2, ne_d)
    njmax_f = min(2, nf_d)
    edges = mesh.edges

    rows, cols, vals = [], [], []

    def moment_rows(r0, nper, nj, vec):
        # rows r0 + f*nper + j: (c0[j] w_a + c1[j] w_b) . vec[f]
        for j in range(nj):
            r = r0 + np.arange(nedge) * nper + j
            for c in range(2):
                for end, cw in ((0, c0[j]), (1, c1[j])):
                    rows.append(r)
                    cols.append(c * nv + edges[:, end])
                    vals.append(cw * vec[:, c])

    moment_rows(0, ne_d, njmax, nvec)
    moment_rows(nhd, nf_d, njmax_f, tau)

    # -- interior completion: M_int[e] maps the element's 6 vertex-velocity
    # values to the interior BDM coefficients minimizing the element-L2
    # distance to the linear field, given the (already set) edge moments.
    n_int = V.hdiv.basis.n_cell
    if interior and n_int > 0:
        hb = V.hdiv.basis
        nbv = hb.n_basis
        n_edge_tot = 3 * ne_d
        q = triangle_rule(2 * hb.order + 2)
        vals_ref, _ = hb.tabulate(q.points)  # (nq, nbv, 2)
        J, detJ, _ = mesh.element_jacobians
        # metric for the physical L2 norm of Piola-mapped fields
        M_e = np.einsum("eca,ecb->eab", J, J,
                        optimize=True) / detJ[:, None, None]
        G = np.einsum("q,qia,eab,qjb->eij", q.weights, vals_ref, M_e,
                      vals_ref, optimize=True)
        # t_mat[e, i, (c,v)] = int uhat_i^T J^T e_c lambda_v
        lam = np.concatenate(
            [1.0 - q.points.sum(1, keepdims=True), q.points], axis=1
        )  # (nq, 3)
        t_mat = np.einsum(
            "q,qia,eca,qv->eicv", q.weights, vals_ref, J, lam, optimize=True
        ).reshape(mesh.ne, nbv, 6)
        # S[e, edge-local-dof, (c,v)]: local edge coefficients from the
        # element's vertex values (local = sign * global edge formula)
        S = np.zeros((mesh.ne, n_edge_tot, 6))
        els = mesh.elements
        for le in range(3):
            eid = mesh.element_edges[:, le]
            ga, gb = edges[eid, 0], edges[eid, 1]
            nsc = nvec[eid]  # (ne, 2) scaled normal of the global edge
            # position of ga, gb among element's vertices
            pos_a = np.argmax(els == ga[:, None], axis=1)
            pos_b = np.argmax(els == gb[:, None], axis=1)
            sgn = V.hdiv.element_signs[:, le * ne_d: (le + 1) * ne_d]
            for j in range(njmax):
                for c in range(2):
                    S[np.arange(mesh.ne), le * ne_d + j, c * 3 + pos_a] += (
                        sgn[:, j] * c0[j] * nsc[:, c]
                    )
                    S[np.arange(mesh.ne), le * ne_d + j, c * 3 + pos_b] += (
                        sgn[:, j] * c1[j] * nsc[:, c]
                    )
        G_ii = G[:, n_edge_tot:, n_edge_tot:]
        G_ie = G[:, n_edge_tot:, :n_edge_tot]
        rhs_int = t_mat[:, n_edge_tot:, :] - np.einsum(
            "eij,ejv->eiv", G_ie, S, optimize=True)
        M_int = np.linalg.solve(G_ii, rhs_int)  # (ne, n_int, 6)
        off_c = nedge * ne_d
        # rows off_c + e*n_int + i, columns c*nv + els[e, v]
        r3 = (off_c + np.arange(mesh.ne)[:, None, None, None] * n_int
              + np.arange(n_int)[None, :, None, None])
        c3 = (np.arange(2)[None, None, :, None] * nv
              + els[:, None, None, :])
        v3 = M_int.reshape(mesh.ne, n_int, 2, 3)
        r3b, c3b, v3b = np.broadcast_arrays(r3, c3, v3)
        rows.append(r3b.ravel())
        cols.append(c3b.ravel())
        vals.append(v3b.ravel())

    Tm = sp.coo_matrix(
        (np.concatenate([np.ravel(v) for v in vals]),
         (np.concatenate([np.ravel(r) for r in rows]),
          np.concatenate([np.ravel(c) for c in cols]))),
        shape=(nV, 2 * nv)).tocsr()
    Tm.eliminate_zeros()
    Ti, Tv = _ell(Tm, dtype, device)
    Tt = Tm.T.tocsr()
    Tt.eliminate_zeros()
    Ri, Rv = _ell(Tt, dtype, device)

    def T(c):
        return _ell_apply(Ti, Tv, c)

    def TT(x):
        return _ell_apply(Ri, Rv, x)

    return T, TT


def _vector_p1_coarse(mesh, dirichlet: str, dtype=torch.float64,
                      coefficient: float = 1.0, device=None):
    """Exact per-component P1 Laplacian solve (the reference's per-component
    aH1_i + h1amg, NavierStokesSIMPLE_iterative.py:310-357), on (2*nv,)
    component-major vectors."""
    space = H1(mesh, 1, dirichlet=dirichlet)
    solve1 = coarse_p1_solver(space, coefficient, dtype, device=device)
    nv = mesh.nv

    def solve(r):
        return solve1(r.reshape(2, nv).T).T.reshape(-1)

    return solve


def hybrid_blocks(V: HybridVelocitySpace, kind: str) -> list[np.ndarray]:
    """Smoother block index sets (free dofs only) for a 2D [HDiv | facet]
    space: ``edgeblock`` = disjoint per-edge + per-cell blocks,
    otherwise overlapping vertex-star patches (all hdiv+facet dofs of
    edges incident to the vertex plus interior dofs of touching
    elements)."""
    mesh = V.mesh
    ne_d, nf_d = V.hdiv.basis.n_edge, V.facet.n_edge
    nc_d = V.hdiv.basis.n_cell
    off_c = mesh.nedge * ne_d
    fmask = V.free_mask
    blocks: list = []
    if kind == "edgeblock":
        for f in range(mesh.nedge):
            blk = list(range(f * ne_d, (f + 1) * ne_d)) + list(
                range(V.hdiv.ndof + f * nf_d, V.hdiv.ndof + (f + 1) * nf_d)
            )
            blocks.append(blk)
        for e in range(mesh.ne):
            blocks.append(list(range(off_c + e * nc_d,
                                     off_c + (e + 1) * nc_d)))
    else:
        vblocks: list[list[int]] = [[] for _ in range(mesh.nv)]
        for f, (a, b) in enumerate(mesh.edges.tolist()):
            dofs_f = list(range(f * ne_d, (f + 1) * ne_d)) + list(
                range(V.hdiv.ndof + f * nf_d, V.hdiv.ndof + (f + 1) * nf_d)
            )
            vblocks[a].extend(dofs_f)
            vblocks[b].extend(dofs_f)
        for e, verts in enumerate(mesh.elements.tolist()):
            dofs_e = list(range(off_c + e * nc_d, off_c + (e + 1) * nc_d))
            for v in verts:
                vblocks[v].extend(dofs_e)
        blocks = vblocks
    blocks = [
        np.asarray([d for d in blk if fmask[d]], np.int32) for blk in blocks
    ]
    return [b for b in blocks if len(b)]


def build_hybrid_preconditioner(
    V: HybridVelocitySpace,
    A_loc_np: np.ndarray,
    a_pre: str,
    velocity_dirichlet: str,
    dtype=torch.float64,
    coarse_coefficient: float = 1.0,
    gs: bool = False,
    A_apply=None,
    device=None,
):
    """A-block preconditioner for [HDiv | facet] systems (the condensed MCS
    Navier-Stokes operator; the HDG Stokes system of the JAX package too).

    ``jacobi`` | ``edgeblock`` (disjoint per-edge + per-cell blocks) |
    ``vertexstar`` (overlapping vertex patches) | ``auxspace``
    (vertexstar + vector-P1 coarse correction -- the reference's MypreA
    structure, NavierStokesSIMPLE_iterative.py:211-391).

    ``gs=True`` switches the block smoother from additive to symmetric
    multicolor block Gauss-Seidel (forward sweep, coarse, backward sweep
    -- MypreA.Mult with GS=True, reference :375-381); requires ``A_apply``,
    the masked operator, for the per-color residual updates.  The block
    inverses are taken on the host in f64 and stored in ``dtype``;
    ``preA.table`` (additive) or ``preA.gs`` (GS) exposes them."""
    if a_pre not in A_PRECONDITIONERS:
        raise ValueError(f"unknown a_pre {a_pre!r}: one of "
                         f"{A_PRECONDITIONERS}")
    device = resolve_device(device)
    mesh = V.mesh
    nV = V.ndof
    free = torch.as_tensor(V.free_mask, device=device)

    if a_pre == "jacobi":
        diag = diagonal_of_local(
            torch.as_tensor(A_loc_np, device=device).to(dtype),
            torch.as_tensor(V.element_dofs.astype(np.int64), device=device),
            nV)
        diag = torch.where(free, diag, 1.0)

        def preA(u):
            return torch.where(free, u / diag, u)

        return preA

    blocks = hybrid_blocks(V, a_pre)
    dofs, mats = extract_blocks_from_local(A_loc_np, V.element_dofs, blocks,
                                           nV)
    if a_pre == "auxspace":
        T, TT = hybrid_h1_embedding(V, dtype, device=device)
        coarse = _vector_p1_coarse(mesh, velocity_dirichlet, dtype,
                                   coefficient=coarse_coefficient,
                                   device=device)

        def coarse_fn(r):
            return T(coarse(TT(r)))
    else:
        coarse_fn = None

    if gs:
        if A_apply is None:
            raise ValueError("gs=True needs the masked operator A_apply")
        colors = color_blocks(blocks, nV, V.element_dofs)
        mgs = MulticolorGS(dofs, mats, colors, nV, dtype, device)
        if coarse_fn is not None:
            rng = np.random.default_rng(7)
            example = torch.as_tensor(rng.standard_normal(nV),
                                      device=device).to(dtype) * free
            coarse_fn, _, _ = damped_coarse(coarse_fn, A_apply, example)
        return symmetric_gs_preconditioner(mgs, A_apply, coarse_fn, free)

    # the JAX package rounds the additive blocks to the model's dtype
    # before its f64 inversion
    if dtype == torch.float32:
        mats = np.asarray(mats, np.float32)
    smooth = block_jacobi(dofs, mats, nV, dtype, device)

    if coarse_fn is not None:

        def preA(u):
            uf = torch.where(free, u, 0.0)
            y = smooth(uf) + coarse_fn(uf)
            return torch.where(free, y, u)

    else:

        def preA(u):
            uf = torch.where(free, u, 0.0)
            return torch.where(free, smooth(uf), u)

    preA.table = smooth.table
    return preA

"""Frozen copy of the port's host assembly for the benchmark's plain
reference: the hybrid velocity spaces, the HDG Stokes tables, the Dirichlet
boundary interpolation, the vertex-star blocks
(``navier_stokes_tpu_torch/models/stokes_hybrid3d.py``) and the 3D MCS
element tables, straight and curved
(``navier_stokes_tpu_torch/models/navier_stokes_mcs.py``), as they stood
when the benchmark was written.  Host numpy in f64; nothing here imports the
program, and nothing here follows a later change to it: the benchmark
holds the program to these tables.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from .fem.facets3d import facet_geometry_3d
from .fem.hdiv3d import HDiv3D, HDivSpace3D
from .fem.quadrature import tetrahedron_rule, triangle_rule
from .fem.reference import TET_FACES, TET_VERTICES, triangle_modal
from .fem.spaces import L2, FunctionSpace

@dataclass
class TangentialFacetSpace3D:
    mesh: object
    order: int
    ndof: int
    dirichlet_names: str = ""

    @property
    def n_scalar(self) -> int:  # scalar modes per face
        return (self.order + 1) * (self.order + 2) // 2

    @property
    def n_face(self) -> int:  # dofs per face (2 frame components)
        return 2 * self.n_scalar

    @cached_property
    def free_mask(self) -> np.ndarray:
        return ~self.boundary_dof_mask(self.dirichlet_names)

    def boundary_dof_mask(self, names: str) -> np.ndarray:
        mask = np.zeros(self.ndof, dtype=bool)
        if not names:
            return mask
        nfd = self.n_face
        for f in self.mesh.boundary_facet_ids(names):
            mask[f * nfd: (f + 1) * nfd] = True
        return mask


def VectorFacet3D(mesh, order: int, dirichlet: str = "") -> TangentialFacetSpace3D:
    nfd = 2 * (order + 1) * (order + 2) // 2
    return TangentialFacetSpace3D(mesh, order, mesh.nface * nfd, dirichlet)


@dataclass
class HybridVelocitySpace3D:
    hdiv: HDivSpace3D
    facet: TangentialFacetSpace3D

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
        mesh = self.mesh
        nfd = self.facet.n_face
        fac = np.zeros((mesh.ne, 4 * nfd), dtype=np.int32)
        for lf in range(4):
            base = self.hdiv.ndof + mesh.element_faces[:, lf] * nfd
            for j in range(nfd):
                fac[:, lf * nfd + j] = base + j
        return np.concatenate([self.hdiv.element_dofs, fac], axis=1)


def bdm_hybrid_3d(order: int, penalty: float = 10.0):
    """3D HDG catalog entry: BDM_k x facet_k x P_{k-1}dc."""

    def discretization(mesh, velocity_dirichlet):
        V = HDiv3D(mesh, order, dirichlet=velocity_dirichlet)
        F = VectorFacet3D(mesh, order, dirichlet=velocity_dirichlet)
        Q = L2(mesh, order - 1)
        return HybridVelocitySpace3D(V, F), Q

    return (discretization, order)


def piola_values(J, X):
    """sum_A J[e, c, A] X[e, ..., A] -> (e, ..., c): one batched product
    per element over all the points and basis functions."""
    ne = X.shape[0]
    return np.matmul(X.reshape(ne, -1, 3), J.transpose(0, 2, 1)).reshape(
        X.shape)


def piola_gradients(J, G, Jinv):
    """J[e] G[e, ..., :, :] Jinv[e] -> (e, ..., c, d): two batched
    products per element."""
    ne = G.shape[0]
    GJ = np.matmul(G.reshape(ne, -1, 3), Jinv)  # rows (..., A), columns d
    GJ = GJ.reshape(ne, -1, 3, 3).transpose(0, 2, 1, 3).reshape(ne, 3, -1)
    out = np.matmul(J, GJ)  # (e, c, (..., d))
    return out.reshape((ne, 3, -1, 3)).transpose(0, 2, 1, 3).reshape(G.shape)


def assemble_hdg_stokes_3d(
    V: HybridVelocitySpace3D, Q: FunctionSpace, alpha: float = 10.0,
    nu: float = 1.0,
):
    """Per-element HDG Stokes tables on the host (f64 numpy):
    ``(A, B, force_local, fg, fvals)`` with A (ne, nloc, nloc) the
    interior-penalty viscous form nu * (grad u, grad v) plus the facet
    consistency, symmetry and penalty terms (penalty alpha k^2 |F|/|T|),
    B (ne, nq, nloc) the b-form div(u) q, ``force_local(force)`` the
    (ne, nloc) load of a volume force, and the facet geometry and modal
    tabulation they were built from.  The JAX package's quadrature sums,
    each one batched matrix product (its einsums contract the full
    (element, point, basis, basis) products: minutes at maxh 0.09)."""
    mesh = V.mesh
    hd = V.hdiv
    k = hd.order
    nbv = hd.n_basis
    nss = V.facet.n_scalar
    nfd = V.facet.n_face  # 2 * nss
    nloc = nbv + 4 * nfd

    J, detJ, Jinv = mesh.element_jacobians
    ne = mesh.ne
    vol = tetrahedron_rule(2 * k + 2)
    w = vol.weights
    nq = len(w)

    v_val, v_grad = hd.tabulate_elements(vol.points)  # per-element tables
    # Piola: value J vhat / detJ; gradient J Ghat Jinv / detJ
    val_p = piola_values(J, v_val) / detJ[:, None, None, None]
    grad_p = piola_gradients(J, v_grad, Jinv) / detJ[:, None, None, None,
                                                       None]

    def gram(X, Y, weight):
        """sum_k X[e, i, k] weight[e, k] Y[e, j, k], batched over e."""
        return np.matmul(X * weight[:, None, :], Y.transpose(0, 2, 1))

    A = np.zeros((ne, nloc, nloc))
    # (e, q, i, c, d) -> (e, i, q*c*d): one batched product per table
    Gt = grad_p.transpose(0, 2, 1, 3, 4).reshape(ne, nbv, nq * 9)
    A[:, :nbv, :nbv] = nu * gram(
        Gt, Gt, np.repeat(w, 9)[None, :] * detJ[:, None])
    del Gt

    fg = facet_geometry_3d(mesh, 2 * k + 2)
    fvals, _ = triangle_modal(fg.qp, V.facet.order)  # (nq2, nss)
    nq2 = len(fg.qp)
    for lf in range(4):
        pts = fg.ref_points[:, lf]  # (ne, nq2, 3) per-element ref coords
        # the reference points of a face depend on the element's combo only:
        # tabulate once per combo group
        tv = np.zeros((ne, nq2, nbv, 3))
        tg = np.zeros((ne, nq2, nbv, 3, 3))
        for cid in range(len(hd.bases)):
            sel = np.where(hd.combo_ids == cid)[0]
            if not len(sel):
                continue
            vals_c, grads_c = hd.bases[cid].tabulate(pts[sel[0]])
            tv[sel] = vals_c[None]
            tg[sel] = grads_c[None]
        n = fg.normal[:, lf]  # (ne, 3)
        v_tp = piola_values(J, tv) / detJ[:, None, None, None]
        # the normal derivative of the Piola gradient, J Ghat (Jinv n)
        # / detJ, without the (e, q, i, c, d) gradient
        Jn = np.einsum("eBd,ed->eB", Jinv, n)
        gn_v = piola_values(J, np.matmul(
            tg.reshape(ne, -1, 3), Jn[:, :, None]).reshape(tv.shape)) \
            / detJ[:, None, None, None]
        del tv, tg
        vn = np.einsum("eqic,ec->eqi", v_tp, n)
        tang_v = v_tp - vn[..., None] * n[:, None, None, :]
        # facet basis: phi_j * E_c, dof index = j * 2 + c
        fbasis = np.zeros((ne, nq2, nfd, 3))
        for j in range(nss):
            for c in range(2):
                fbasis[:, :, j * 2 + c, :] = (
                    fvals[None, :, j, None] * fg.frame[:, lf, c][:, None, :]
                )
        # the rows this face couples: the volume basis and its own facet
        # dofs; the jump is [-tang v | facet basis], the flux [dv/dn | 0]
        cols = np.concatenate([np.arange(nbv),
                               nbv + lf * nfd + np.arange(nfd)])
        jump = np.concatenate([-tang_v, fbasis], axis=2).transpose(
            0, 2, 1, 3).reshape(ne, nbv + nfd, nq2 * 3)
        gn = np.zeros_like(jump)
        gn[:, :nbv] = gn_v.transpose(0, 2, 1, 3).reshape(ne, nbv, nq2 * 3)
        ds = fg.area[:, lf]
        wq = np.repeat(fg.qw, 3)[None, :] * ds[:, None]
        # sliver-robust penalty alpha k^2 |F|/|T|: |F| = area/2, |T| = detJ/6
        pen = alpha * k * k * 3.0 * fg.area[:, lf] / detJ
        jg = gram(jump, gn, wq)
        blk = jg + jg.transpose(0, 2, 1) + gram(jump, jump,
                                                wq * pen[:, None])
        A[:, cols[:, None], cols[None, :]] += nu * blk

    # b-form: pressure x velocity
    qvals, _ = Q.basis.tabulate(vol.points)
    div_ref = np.einsum("eqicc->eqi", v_grad)
    B = np.zeros((ne, qvals.shape[1], nloc))
    B[:, :, :nbv] = np.einsum("q,qp,eqi->epi", w, qvals, div_ref, optimize=True)

    # rhs builder
    qpts = mesh.points[mesh.elements[:, 0]][:, None, :] + np.einsum(
        "eab,qb->eqa", J, vol.points
    , optimize=True)

    def force_local(force):
        fq = force(qpts.reshape(-1, 3)).reshape(ne, -1, 3)
        fe = np.zeros((ne, nloc))
        fe[:, :nbv] = np.einsum("q,eqc,eqic,e->ei", w, fq, val_p, detJ,
                                optimize=True)
        return fe

    return A, B, force_local, fg, fvals


def interpolate_hybrid_boundary_3d(
    V: HybridVelocitySpace3D, uin, names: str
) -> np.ndarray:
    """Normal moments + tangential frame moments of ``uin`` on the named
    boundary faces (global-frame functionals; see fem/hdiv3d docstring)."""
    mesh = V.mesh
    nfd_v = V.hdiv.n_face_dofs
    nss = V.facet.n_scalar
    nfd_f = V.facet.n_face

    rule = triangle_rule(2 * V.hdiv.order + 2)
    # separate tabulations per order: triangle_modal orders modes as
    # [(0,0),(0,1),(0,2),...], so the first nss columns of a HIGHER-order
    # tabulation are NOT the facet space's modes when the orders differ
    fvals, _ = triangle_modal(rule.points, V.hdiv.order)
    fvals_f, _ = triangle_modal(rule.points, V.facet.order)
    u = np.zeros(V.ndof)
    pts = mesh.points
    for f in mesh.boundary_facet_ids(names):
        gv = pts[mesh.faces[f]]  # sorted global vertices
        E1, E2 = gv[1] - gv[0], gv[2] - gv[0]
        nsc = np.cross(E1, E2)  # scaled normal (the Piola moment normal)
        xq = (
            gv[0][None, :]
            + rule.points[:, 0:1] * E1[None, :]
            + rule.points[:, 1:2] * E2[None, :]
        )
        uq = uin(xq)
        for j in range(nfd_v):
            u[f * nfd_v + j] = np.einsum(
                "q,qc,c,q->", rule.weights, uq, nsc, fvals[:, j]
            , optimize=True)
        # facet frame coefficients via the 2x2 frame Gram
        G = np.array([[E1 @ E1, E1 @ E2], [E2 @ E1, E2 @ E2]])
        Ginv = np.linalg.inv(G)
        tang = uq - (uq @ (nsc / np.linalg.norm(nsc)))[:, None] * (
            nsc / np.linalg.norm(nsc)
        )[None, :]
        for j in range(nss):
            m = np.array([
                np.einsum("q,qc,c,q->", rule.weights, tang, E1, fvals_f[:, j], optimize=True),
                np.einsum("q,qc,c,q->", rule.weights, tang, E2, fvals_f[:, j], optimize=True),
            ])
            c = Ginv @ m
            u[V.hdiv.ndof + f * nfd_f + 2 * j] = c[0]
            u[V.hdiv.ndof + f * nfd_f + 2 * j + 1] = c[1]
    return u


def hybrid_blocks_3d(V: HybridVelocitySpace3D, kind: str) -> list:
    """Smoother block index sets for a 3D [H(div) | facet] space.

    ``face``: disjoint per-face blocks (hdiv + facet dofs) and per-cell
    interior blocks.  ``vertexstar``: overlapping vertex patches -- all
    face/facet dofs of the faces containing the vertex and the interior
    dofs of the incident tets."""
    mesh = V.mesh
    nfd_v, nfd_f = V.hdiv.n_face_dofs, V.facet.n_face
    nc_d = V.hdiv.bases[0].n_cell
    off_c = mesh.nface * nfd_v
    if kind == "face":
        blocks = []
        for f in range(mesh.nface):
            blocks.append(
                list(range(f * nfd_v, (f + 1) * nfd_v))
                + list(range(V.hdiv.ndof + f * nfd_f,
                             V.hdiv.ndof + (f + 1) * nfd_f)))
        for e in range(mesh.ne):
            blocks.append(list(range(off_c + e * nc_d,
                                     off_c + (e + 1) * nc_d)))
        return blocks
    if kind != "vertexstar":
        raise ValueError(f"unknown block kind {kind!r}")
    vblocks: list[list[int]] = [[] for _ in range(mesh.nv)]
    for f, verts in enumerate(mesh.faces.tolist()):
        dofs_f = (list(range(f * nfd_v, (f + 1) * nfd_v))
                  + list(range(V.hdiv.ndof + f * nfd_f,
                               V.hdiv.ndof + (f + 1) * nfd_f)))
        for v in verts:
            vblocks[v].extend(dofs_f)
    for e, verts in enumerate(mesh.elements.tolist()):
        dofs_e = list(range(off_c + e * nc_d, off_c + (e + 1) * nc_d))
        for v in verts:
            vblocks[v].extend(dofs_e)
    return vblocks


def free_blocks(V: HybridVelocitySpace3D, kind: str) -> list[np.ndarray]:
    """The free dofs of each :func:`hybrid_blocks_3d` block; empty blocks
    dropped."""
    fmask = V.free_mask
    blks = [np.asarray([d for d in blk if fmask[d]], np.int32)
            for blk in hybrid_blocks_3d(V, kind)]
    return [b for b in blks if len(b)]



def _assemble_mcs_ns_local_3d(mesh, V, facet_space, sigma_basis, Wq_basis,
                              Q_basis, nu):
    """3D element-local 4-field MCS matrices on tets.

    Counterpart of ``_assemble_mcs_ns_local`` for mesh.dim == 3 (the
    reference's class is dimension-generic,
    NavierStokesSIMPLE_iterative.py:28-36,53-70): V is a combo-cached
    HDivSpace3D (BDM tets), ``facet_space`` the tangential facet space in
    each face's global frame, ``sigma_basis`` the trace-free tet stress
    element (fem/hcurldiv3d), and the vorticity multiplier is the
    3-component VectorL2 field W with Skew2Vec(m) = (m01-m10, m20-m02,
    m12-m21) (reference :57-58).  3D H(div) face dofs are global-frame
    moments, so no orientation signs exist.

    Affine factorization: every physical integral is a combo-level
    REFERENCE integral (shared across all elements with the same face
    orientations) contracted with a small per-element geometry tensor
    built from J / Jinv / detJ — no per-element quadrature arrays are ever
    materialized, so host assembly cost is a handful of GEMMs:

      sigma_phys : tau_phys = (1/detJ^2) sigmahat : (Ginv tauhat G),
      skw_c(sigma_phys)     = K[c,a,b] sigmahat_ab / detJ,
      (sigma_phys n)_i      = (1/detJ) Jinv[a,i] (sigmahat J^T n)_a,
      v_phys . n            = vhat . (J^T n) / detJ.

    Returns (A_ret, A_rc, A_cc, M_full, B_loc): the retained/eliminated
    blocks plus the velocity mass on the retained block and the pressure
    divergence coupling (per-element tables the model ships to device).
    """
    k = V.order
    nbv = V.n_basis
    sb = sigma_basis
    nbs = sb.n_basis
    nss = facet_space.n_scalar
    nfd = facet_space.n_face  # 2 * nss
    nfac = 4 * nfd
    nbw_s = Wq_basis.n_basis  # scalar modes; W has 3 components
    nbw = 3 * nbw_s

    J, detJ, Jinv = mesh.element_jacobians
    ne = mesh.ne
    vol = tetrahedron_rule(2 * k + 2)
    w = vol.weights
    nq = len(w)

    s_val, s_grad = sb.tabulate(vol.points)  # shared reference tables
    w_val, _ = Wq_basis.tabulate(vol.points)
    q_val, _ = Q_basis.tabulate(vol.points)
    ncombo = len(V.bases)
    combo_sel = [np.where(V.combo_ids == c)[0] for c in range(ncombo)]
    vtabs = [V.bases[c].tabulate(vol.points) for c in range(ncombo)]

    n_ret = nbv + nfac
    n_el = nbs + nbw
    A_ret = np.zeros((ne, n_ret, n_ret))
    A_rc = np.zeros((ne, n_ret, n_el))
    A_cc = np.zeros((ne, n_el, n_el))
    M_full = np.zeros((ne, n_ret, n_ret))
    B_loc = np.zeros((ne, q_val.shape[1], n_ret))

    G = np.matmul(J.transpose(0, 2, 1), J)
    Ginv = np.linalg.inv(G)

    # -(1/(2 nu)) sigma:tau: D[a,c,d,b][n,m] = sum_q w shat[q,n,a,b]
    # shat[q,m,c,d]; per element contract with Ginv[a,c] G[d,b] / detJ.
    sw = s_val * w[:, None, None, None]
    D = np.tensordot(sw, s_val, axes=(0, 0))  # (nbs,3a,3b, nbs,3c,3d)
    D2 = np.ascontiguousarray(D.transpose(1, 4, 5, 2, 0, 3)).reshape(
        81, nbs * nbs
    )  # (a,c,d,b) x (n,m)
    CC = (Ginv[:, :, None, None, :] * G.transpose(0, 2, 1)[:, None, :, :, None]
          ).transpose(0, 1, 4, 2, 3)  # [e,a,c,d,b] = Ginv[e,a,c] G[e,d,b]
    A_cc[:, :nbs, :nbs] += (-(0.5 / nu) / detJ)[:, None, None] * np.matmul(
        CC.reshape(ne, 81), D2
    ).reshape(ne, nbs, nbs)

    # vorticity multiplier Skew2Vec (reference :57-58): skw_c(sigma_phys) =
    # K[e,c,a,b] sigmahat_ab / detJ; detJ cancels against the volume element
    K = np.stack(
        [
            np.einsum("ea,eb->eab", Jinv[:, :, 0], J[:, 1, :])
            - np.einsum("ea,eb->eab", Jinv[:, :, 1], J[:, 0, :]),
            np.einsum("ea,eb->eab", Jinv[:, :, 2], J[:, 0, :])
            - np.einsum("ea,eb->eab", Jinv[:, :, 0], J[:, 2, :]),
            np.einsum("ea,eb->eab", Jinv[:, :, 1], J[:, 2, :])
            - np.einsum("ea,eb->eab", Jinv[:, :, 2], J[:, 1, :]),
        ],
        axis=1,
    )  # (ne, 3, 3, 3)
    # WS[nw, m, a, b] = sum_q w wval[q,nw] shat[q,m,a,b]
    WS = np.tensordot(w_val * w[:, None], s_val, axes=(0, 0))
    wr = np.tensordot(
        K.reshape(ne * 3, 9), WS.transpose(2, 3, 0, 1).reshape(9, nbw_s * nbs),
        axes=(1, 0),
    ).reshape(ne, 3, nbw_s, nbs).reshape(ne, nbw, nbs)
    A_cc[:, nbs:, :nbs] += wr
    A_cc[:, :nbs, nbs:] += wr.transpose(0, 2, 1)

    # div(sigma).v: per-combo reference integral E_c[i,m], scaled 1/detJ
    div_s_ref = np.einsum("qnabb->qna", s_grad)
    wdsr = w[:, None, None] * div_s_ref  # (nq, nbs, 3)
    for c in range(ncombo):
        sel = combo_sel[c]
        if not len(sel):
            continue
        vv, vg = vtabs[c]
        E_c = np.tensordot(
            vv.reshape(nq, nbv, 3), wdsr, axes=([0, 2], [0, 2])
        )  # (nbv, nbs)
        A_rc[sel, :nbv, :nbs] += E_c[None] / detJ[sel, None, None]
        # grad-div 2 nu (div u)(div v) / detJ and mass / B from the same tabs
        dvr = np.einsum("qiaa->qi", vg)  # (nq, nbv)
        GD = dvr.T @ (dvr * w[:, None])
        A_ret[sel, :nbv, :nbv] += (2.0 * nu / detJ[sel, None, None]) * GD[None]
        # velocity mass: M[e] = (1/detJ) G[e,a,b] C[a,b] with
        # C[a,b,i,j] = sum_q w vhat[q,i,a] vhat[q,j,b]
        Cab = np.einsum("qia,qjb->abij", vv * w[:, None, None], vv, optimize=True)
        M_full[sel[:, None, None], np.arange(nbv)[None, :, None],
               np.arange(nbv)[None, None, :]] = np.matmul(
            G[sel].reshape(-1, 1, 9), Cab.reshape(9, nbv * nbv)[None]
        ).reshape(len(sel), nbv, nbv) / detJ[sel, None, None]
        # pressure coupling: int div(u) q dx = int_ref divhat qhat
        B_loc[sel, :, :nbv] = ((q_val * w[:, None]).T @ dvr)[None]

    # facet terms over the 4 faces (global-frame quadrature): combo-level
    # trace integrals T1/S2 contracted with per-element (m, r, s) vectors,
    # m = J^T n, r = Jinv n, s_d = Jinv E_d.
    fg = facet_geometry_3d(mesh, 2 * k + 2)
    fvals, _ = triangle_modal(fg.qp, facet_space.order)  # (nq2, nss)
    fw = fvals * fg.qw[:, None]
    for lf in range(4):
        nrm = fg.normal[:, lf]
        ds = fg.area[:, lf]
        m_e = np.einsum("eba,eb->ea", J, nrm)  # J^T n
        r_e = np.einsum("eab,eb->ea", Jinv, nrm)  # Jinv n
        s_e = np.matmul(Jinv[:, None], fg.frame[:, lf, :, :, None]).squeeze(-1)
        # (ne, 2, 3): s_d = Jinv E_d
        for c in range(ncombo):
            sel = combo_sel[c]
            if not len(sel):
                continue
            p0 = fg.ref_points[sel[0], lf]
            vtr = V.bases[c].tabulate(p0)[0]  # (nq2, nbv, 3)
            str_ = sb.tabulate(p0)[0]  # (nq2, nbs, 3, 3)
            # T1[c3,a,b][i,m] = sum_q w2 vtr[q,i,c3] str[q,m,a,b]
            T1 = np.tensordot(
                vtr * fg.qw[:, None, None], str_, axes=(0, 0)
            )  # (nbv, 3c3, nbs, 3a, 3b)
            T1 = np.ascontiguousarray(T1.transpose(1, 3, 4, 0, 2)).reshape(
                27, nbv * nbs
            )
            # -(sigma n.n)(v.n): coeff = m_c3 r_a m_b * ds / detJ^2
            co = (
                m_e[sel][:, :, None, None]
                * r_e[sel][:, None, :, None]
                * m_e[sel][:, None, None, :]
            ).reshape(len(sel), 27)
            blk = np.matmul(co, T1).reshape(len(sel), nbv, nbs)
            A_rc[sel, :nbv, :nbs] -= blk * (
                ds[sel] / detJ[sel] ** 2
            )[:, None, None]
            # -(sigma n).tang(uhat): S2[a,b][j,m] = sum_q w2 f[q,j] str[q,m,a,b]
            S2 = np.tensordot(fw, str_, axes=(0, 0))  # (nss, nbs, 3a, 3b)
            S2 = np.ascontiguousarray(S2.transpose(2, 3, 0, 1)).reshape(
                9, nss * nbs
            )
            co2 = (
                s_e[sel][:, :, :, None] * m_e[sel][:, None, None, :]
            ).reshape(len(sel) * 2, 9)
            blk2 = np.matmul(co2, S2).reshape(len(sel), 2, nss, nbs)
            blk2 = blk2.transpose(0, 2, 1, 3).reshape(len(sel), nfd, nbs)
            A_rc[
                sel[:, None, None],
                nbv + lf * nfd + np.arange(nfd)[None, :, None],
                np.arange(nbs)[None, None, :],
            ] -= blk2 * (ds[sel] / detJ[sel])[:, None, None]
    return A_ret, A_rc, A_cc, M_full, B_loc


def _assemble_mcs_ns_local_curved_3d(V, facet_space, sigma_basis, Wq_basis,
                                     Q_basis, nu, geometry, A_ret, A_rc, A_cc,
                                     M_full, B_loc):
    """Overwrite the CURVED-element rows of the affine 3D MCS tables with
    the isoparametric (order-g tet Lagrange map) assembly.

    Counterpart of ``_assemble_mcs_ns_local_curved_3d`` of the JAX package.
    Only ``geometry.curved_elements`` are re-assembled per quadrature point;
    all other elements keep the affine tables.  Pullbacks:

      sigma_phys_ij = Jinv_ai sigmahat_ab J_jb / detJ     (H(curl,div))
      v_phys        = J vhat / detJ                        (H(div) Piola)
      div u         = divhat u / detJ
      d_B detJ      = detJ tr(Jinv dJ/dB)                  (Jacobi)

    div(sigma_phys) picks up the curvature terms of dJinv, dJ and ddet.
    Facet integrals use the exact curved scaled normal of each face's
    sorted-global reference frame; the facet space keeps its affine-face
    frame, and sigma.n is tangentialized against the curved unit normal.
    Mutates the five tables in place."""
    from .mesh.curved import geometry_hessian_3d, geometry_tables_3d

    mesh = V.mesh
    sel_all = np.asarray(geometry.curved_elements)
    if not len(sel_all):
        return
    gb = geometry.basis
    k = V.order
    nbv = V.n_basis
    sb = sigma_basis
    nbs = sb.n_basis
    nfd = facet_space.n_face
    nbw = 3 * Wq_basis.n_basis

    # 2k+3: one degree above the affine assembler's exactness (the curved
    # integrands are rational)
    vol = tetrahedron_rule(2 * k + 3)
    w = vol.weights
    s_val, s_grad = sb.tabulate(vol.points)  # (nq,nbs,3,3), (nq,nbs,3,3,3)
    w_val, _ = Wq_basis.tabulate(vol.points)
    q_val, _ = Q_basis.tabulate(vol.points)
    vtabs = [b.tabulate(vol.points) for b in V.bases]

    A_ret[sel_all] = 0.0
    A_rc[sel_all] = 0.0
    A_cc[sel_all] = 0.0
    M_full[sel_all] = 0.0
    B_loc[sel_all] = 0.0

    # 64-element chunks bound the per-point intermediates (~2.6 MB/element)
    for chunk in np.array_split(sel_all, max(1, len(sel_all) // 64)):
        nc = len(chunk)
        J, detJ, Jinv, _ = geometry_tables_3d(
            geometry.coords[chunk], gb, vol.points)
        H = geometry_hessian_3d(geometry.coords[chunk], gb, vol.points)
        cids = V.combo_ids[chunk]
        v_val = np.stack([vtabs[c][0] for c in cids])  # (nc, nq, nbv, 3)
        v_grad = np.stack([vtabs[c][1] for c in cids])

        sp = np.einsum(
            "eqai,qnab,eqjb->eqnij", Jinv, s_val, J, optimize=True
        ) / detJ[..., None, None, None]
        A_cc[chunk, :nbs, :nbs] += -(0.5 / nu) * np.einsum(
            "q,eqnij,eqmij,eq->enm", w, sp, sp, detJ, optimize=True)
        skw = np.stack(
            [
                sp[..., 0, 1] - sp[..., 1, 0],
                sp[..., 2, 0] - sp[..., 0, 2],
                sp[..., 1, 2] - sp[..., 2, 1],
            ],
            axis=2,
        )  # (nc, nq, 3, nbs)
        wr = np.einsum(
            "q,qn,eqcm,eq->ecnm", w, w_val, skw, detJ, optimize=True
        ).reshape(nc, nbw, nbs)
        A_cc[chunk, nbs:, :nbs] += wr
        A_cc[chunk, :nbs, nbs:] += wr.transpose(0, 2, 1)

        # div(sigma) with curvature terms, contracted term by term
        ddet = detJ[..., None] * np.einsum(
            "eqdc,eqcdB->eqB", Jinv, H, optimize=True)
        dJinv = -np.einsum(
            "eqac,eqcdB,eqdi->eqaiB", Jinv, H, Jinv, optimize=True)
        JJ = np.einsum("eqjb,eqBj->eqbB", J, Jinv, optimize=True)
        div_s = (
            np.einsum("eqaiB,qnab,eqbB->eqni", dJinv, s_val, JJ,
                      optimize=True)
            + np.einsum("eqai,qnabB,eqbB->eqni", Jinv, s_grad, JJ,
                        optimize=True)
            + np.einsum("eqai,qnab,eqjbB,eqBj->eqni", Jinv, s_val, H,
                        Jinv, optimize=True)
        ) / detJ[..., None, None]
        dd2 = np.einsum("eqB,eqBj->eqj", ddet / detJ[..., None], Jinv,
                        optimize=True)
        div_s -= np.einsum("eqnij,eqj->eqni", sp, dd2, optimize=True)
        Jv = np.einsum("eqcA,eqnA->eqnc", J, v_val, optimize=True)
        A_rc[chunk, :nbv, :nbs] += np.einsum(
            "q,eqmi,eqni->enm", w, div_s, Jv, optimize=True)

        # grad-div, pressure coupling, velocity mass
        dvr = np.einsum("eqnaa->eqn", v_grad)
        A_ret[chunk, :nbv, :nbv] += 2.0 * nu * np.einsum(
            "q,eqn,eqm,eq->enm", w, dvr, dvr, 1.0 / detJ, optimize=True)
        B_loc[chunk, :, :nbv] = np.einsum(
            "q,qp,eqn->epn", w, q_val, dvr, optimize=True)
        G = np.einsum("eqca,eqcb->eqab", J, J, optimize=True)
        M_full[chunk, :nbv, :nbv] = np.einsum(
            "q,eqna,eqab,eqmb,eq->enm", w, v_val, G, v_val, 1.0 / detJ,
            optimize=True)

    # facet terms, grouped by combo so each face's (orientation-dependent)
    # reference points are shared within a group
    fg = facet_geometry_3d(mesh, 2 * k + 4)
    fvals, _ = triangle_modal(fg.qp, facet_space.order)  # (nq2, nss)
    for c in range(len(V.bases)):
        sel_c = sel_all[V.combo_ids[sel_all] == c]
        if not len(sel_c):
            continue
        for lf in range(4):
            for sel in np.array_split(sel_c, max(1, len(sel_c) // 256)):
                p0 = fg.ref_points[sel[0], lf]
                Jf, detf, Jinvf, _ = geometry_tables_3d(
                    geometry.coords[sel], gb, p0)
                vtr, _ = V.bases[c].tabulate(p0)  # (nq2, nbv, 3)
                str_, _ = sb.tabulate(p0)  # (nq2, nbs, 3, 3)
                perm = fg.face_perm[sel[0], lf]
                lv = TET_VERTICES[np.asarray(TET_FACES[lf])[perm]]
                e1r, e2r = lv[1] - lv[0], lv[2] - lv[0]
                t1 = np.einsum("eqcd,d->eqc", Jf, e1r, optimize=True)
                t2 = np.einsum("eqcd,d->eqc", Jf, e2r, optimize=True)
                nsc = np.cross(t1, t2)  # (nc, nq2, 3), |.| = dS/(ds dt)
                sgn = np.sign(np.einsum(
                    "eqc,ec->eq", nsc, fg.normal[sel, lf]).sum(axis=1))
                nsc *= sgn[:, None, None]  # outward, as the affine normal
                dsq = np.linalg.norm(nsc, axis=-1)
                n_unit = nsc / dsq[..., None]

                v_tp = np.einsum(
                    "eqcA,qiA->eqic", Jf, vtr, optimize=True
                ) / detf[..., None, None]
                s_tp = np.einsum(
                    "eqai,qnab,eqjb->eqnij", Jinvf, str_, Jf, optimize=True
                ) / detf[..., None, None, None]
                vn = np.einsum("eqic,eqc->eqi", v_tp, n_unit, optimize=True)
                sn = np.einsum("eqnij,eqj->eqni", s_tp, n_unit,
                               optimize=True)
                snn = np.einsum("eqni,eqi->eqn", sn, n_unit, optimize=True)
                A_rc[sel, :nbv, :nbs] -= np.einsum(
                    "q,eqm,eqi,eq->eim", fg.qw, snn, vn, dsq, optimize=True)
                # tangential facet pairing in the affine-face frame E_d;
                # facet dof ordering j*2+d as the affine path
                sn_t = sn - snn[..., None] * n_unit[:, :, None, :]
                Ed = fg.frame[sel, lf]  # (nc, 2, 3)
                blk2 = np.einsum(
                    "q,qj,eqmc,edc,eq->ejdm", fg.qw, fvals, sn_t, Ed, dsq,
                    optimize=True,
                ).reshape(len(sel), nfd, nbs)
                A_rc[
                    sel[:, None, None],
                    nbv + lf * nfd + np.arange(nfd)[None, :, None],
                    np.arange(nbs)[None, None, :],
                ] -= blk2

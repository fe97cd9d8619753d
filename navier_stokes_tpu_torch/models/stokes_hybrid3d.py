"""3D hybrid-DG Stokes on BDM tets x tangential facet spaces.

Counterpart of ``navier_stokes_tpu/models/stokes_hybrid3d.py``: the
tangential facet space in each face's global frame, the hybrid velocity
space, the Dirichlet boundary interpolation (pure numpy), the smoother
blocks with the additive face-block preconditioner, and the HDG Stokes
discretization -- ``bdm_hybrid_3d`` (BDM_k x facet_k x P_{k-1}dc),
``assemble_hdg_stokes_3d`` (interior-penalty viscous form and the b-form
as per-element tables, host numpy, the JAX package's operations in its
order) and ``build_hybrid_stokes_system_3d`` (the masked operators of the
saddle system on the device: every square element product through the
hand-written ``batched_local_matvec``, every scatter a deterministic
``ScatterPlan``).

Facet space: per global face, 2 * nfd dofs — coefficients of
phi_j(s,t) * E_c where phi is the orthonormal Dubiner basis in the face's
sorted-global parametrization and (E_1, E_2) the physical global tangent
frame.  Both neighboring tets evaluate these identically, so no orientation
algebra is needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..device import resolve_device
from ..fem.hdiv3d import HDiv3D, HDivSpace3D
from ..fem.quadrature import tetrahedron_rule, triangle_rule
from ..fem.reference import triangle_modal
from ..fem.spaces import L2, FunctionSpace
from ..ops.assembly import (
    ScatterPlan,
    apply_local_matrices,
    diagonal_of_local,
    mass_diagonal,
)
from ..ops.facets3d import facet_geometry_3d
from ..precond.jacobi import block_jacobi, extract_blocks_from_local
from .stokes import StokesSystem


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


def build_faceblock_preconditioner_3d(V: HybridVelocitySpace3D,
                                      A_np: np.ndarray, dtype=torch.float64,
                                      blocks: str = "face", device=None):
    """Additive block smoother over the free dofs of the
    :func:`hybrid_blocks_3d` patches: batched dense inverses of the
    assembled operator's blocks (precond/jacobi.block_jacobi);
    ``preA.table`` is their stored inverses."""
    device = resolve_device(device)
    nV = V.ndof
    dofs, mats = extract_blocks_from_local(A_np, V.element_dofs,
                                           free_blocks(V, blocks), nV)
    smooth = block_jacobi(dofs, mats, nV, dtype, device)
    free = torch.as_tensor(V.free_mask, device=device)

    def preA(u):
        uf = torch.where(free, u, 0.0)
        return torch.where(free, smooth(uf), u)

    preA.table = smooth.table
    return preA


def build_hybrid_stokes_system_3d(
    mesh,
    discretization,
    velocity_dirichlet: str,
    uin=None,
    volume_force=None,
    alpha: float = 10.0,
    dtype=torch.float64,
    a_pre: str = "faceblock",
    device=None,
) -> StokesSystem:
    """The 3D HDG Stokes saddle system of ``discretization``
    (:func:`bdm_hybrid_3d`) on ``mesh``, as masked operators on ``device``
    (CUDA unless the caller asks for the CPU): A through the hand-written
    ``batched_local_matvec`` (its plain version on the CPU), B and B^T
    plain products, both scatters deterministic.  ``a_pre``: the face-block
    smoother (``"faceblock"``) or Jacobi on the assembled diagonal."""
    device = resolve_device(device)
    V, Q = discretization(mesh, velocity_dirichlet)
    A_np, B_np, force_local, _, _ = assemble_hdg_stokes_3d(V, Q, alpha)
    nV, nQ = V.ndof, Q.ndof

    def ship(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    plan_v = ScatterPlan(torch.as_tensor(V.element_dofs, device=device), nV)
    plan_p = ScatterPlan(torch.as_tensor(Q.element_dofs, device=device), nQ)
    A_loc = ship(A_np).contiguous()
    B_loc = ship(B_np)
    free = torch.as_tensor(V.free_mask, device=device)

    def A_raw(u):
        return apply_local_matrices(A_loc, plan_v, nV, u, use_kernel=True)

    def A(u):
        uf = torch.where(free, u, 0.0)
        return torch.where(free, A_raw(uf), u)

    def B_raw(u):
        return plan_p(torch.einsum("epi,ei->ep", B_loc, u[plan_v.index]))

    def B(u):
        return B_raw(torch.where(free, u, 0.0))

    def BT(p):
        ue = torch.einsum("epi,ep->ei", B_loc, p[plan_p.index])
        return torch.where(free, plan_v(ue), 0.0)

    if a_pre == "faceblock":
        preA = build_faceblock_preconditioner_3d(V, A_np, dtype,
                                                 device=device)
    else:
        diag = diagonal_of_local(A_loc, plan_v, nV)
        diag = torch.where(free, diag.abs(), 1.0)

        def preA(u):
            return torch.where(free, u / diag, u)

    diag_Mp = ship(mass_diagonal(Q))

    def preM(p):
        return p / diag_Mp

    if volume_force is None:
        f_vec = torch.zeros(nV, dtype=dtype, device=device)
    else:
        f_vec = plan_v(ship(force_local(volume_force)))
    if uin is None:
        u_bc = torch.zeros(nV, dtype=dtype, device=device)
    else:
        u_bc = ship(interpolate_hybrid_boundary_3d(V, uin,
                                                   velocity_dirichlet))
    f_mod = torch.where(free, f_vec - A_raw(u_bc), 0.0)
    g_mod = -B_raw(u_bc)
    return StokesSystem(V=V, Q=Q, A=A, B=B, BT=BT, preA=preA, preM=preM,
                        f=f_mod, g=g_mod, u_bc=u_bc, ndofs=nV + nQ)

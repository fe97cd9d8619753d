"""Auxiliary-space P1 coarse corrections for 3D [H(div) | facet] systems.

Counterpart of ``navier_stokes_tpu/models/auxspace3d.py``.  For the 3D HDG
model (models/navier_stokes_hdg3d.py): the vector-P1 embedding
``hybrid_h1_embedding_3d`` (T, T^T) and ``build_auxspace_preconditioner_3d``,
a vertex-star block smoother plus the P1 coarse solve, additive or
multicolor GS.  For the condensed 3D MCS operator, the skeleton
preconditioner of the fast face-block path:

  preA = E pre_skel E^T + I_i A_ii^{-1} I_i^T,

with E the harmonic extension of skeleton values into element interiors
and pre_skel a preconditioner of the skeleton Schur complement S, built
from the edge-star blocks of S (ops/faceblock.FaceStarSmoother) and the
vector-P1 auxiliary-space coarse correction through the face-layout
transfer:

* ``gs=True`` (bench.py's default): the symmetric multicolor block-GS sweep
  -- forward colors, the damped coarse correction on the residual, backward
  colors -- with each color's residual from row panels of S;
* ``gs=False``: the additive edge-star smoother plus the coarse correction.

Every table apply (extension, its transpose, interior solve, M_F and
M_F^T, S, edge-star inverses, GS panels and color solves) is a
:func:`~navier_stokes_tpu_torch.ops.block_mv.block_mv` launch, or with
``split_k`` > 1 a :func:`~navier_stokes_tpu_torch.ops.block_mv.
block_mv_splitk` launch for the tables the JAX package splits (all but the
GS panels and color solves).  Built in f64 (``dtype`` and every storage
group float64, the 3D model's own preconditioner), every table apply is a
plain batched f64 product instead, as the JAX package's einsum route.

The interior Schur complement and the edge-star inverses are computed in
f64 (host numpy, resp. torch f64 on the device) and cast to the storage
dtypes, as the JAX package's host path does.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from ..fem.quadrature import tetrahedron_rule, triangle_rule
from ..fem.reference import triangle_modal
from ..fem.spaces import H1
from ..ops.assembly import assemble_csr
from ..ops.block_mv import make_table_apply
from ..ops.faceblock import (
    FaceBlockLayout,
    face_star_smoother,
    symmetric_part,
)
from ..precond.amg import _ell, _ell_apply
from ..precond.jacobi import (
    block_inverses,
    block_jacobi_inverses,
    extract_blocks_csr,
    padded_blocks,
)
from ..precond.multicolor import (
    MulticolorGS,
    color_blocks,
    damped_coarse,
    symmetric_gs_preconditioner,
)
from ..precond.twolevel import coarse_p1_solver
from .stokes_hybrid3d import free_blocks, piola_values

__all__ = ["hybrid_h1_face_transfer", "build_skeleton_preconditioner_3d",
           "hybrid_h1_embedding_3d", "build_auxspace_preconditioner_3d"]


def _p1_face_moments(V):
    """The per-face data of the vector-P1 embedding: ``cjv`` / ``cjv_fac``
    (int_T phi_j lambda_v over the unit triangle for the H(div) and facet
    modes; tabulated separately per order, as triangle_modal's mode
    ordering makes the first columns of a higher-order tabulation NOT the
    lower-order modes), the faces' sorted vertices, the scaled normals
    (the Piola moment normal) and W = G^-1 E, the frame coefficients of a
    tangent vector ((nface, 2, 3); E the two face edges, G their Gram)."""
    mesh = V.mesh
    rule2 = triangle_rule(2 * max(V.hdiv.order, V.facet.order) + 2)
    phi_v, _ = triangle_modal(rule2.points, V.hdiv.order)
    phi_f, _ = triangle_modal(rule2.points, V.facet.order)
    lam2 = np.concatenate(
        [1 - rule2.points.sum(1, keepdims=True), rule2.points], axis=1
    )
    cjv = np.einsum("q,qj,qv->jv", rule2.weights, phi_v, lam2)
    cjv_fac = np.einsum("q,qj,qv->jv", rule2.weights, phi_f, lam2)
    faces = np.asarray(mesh.faces)
    fv = mesh.points[faces]
    E = np.stack([fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0]], axis=1)
    nsc = np.cross(E[:, 0], E[:, 1])
    G = np.einsum("fdc,fec->fde", E, E)
    W = np.einsum("fde,fec->fdc", np.linalg.inv(G), E)
    return cjv, cjv_fac, faces, nsc, W


def face_transfer_table(V, nfb: int):
    """(M_F, faces): the per-face dense maps (nface, nfb, 9) of the
    face-layout P1 transfer, from the face's 3 vertices x 3 components
    (hdiv moment rows, then facet frame rows), and the faces' vertices."""
    nfd_v = V.hdiv.n_face_dofs
    nss = V.facet.n_scalar
    nface = V.mesh.nface
    cjv, cjv_fac, faces, nsc, W = _p1_face_moments(V)
    M_F = np.zeros((nface, nfb, 9))
    M_F[:, :nfd_v] = np.einsum(
        "jv,fc->fjvc", cjv[:nfd_v], nsc
    ).reshape(nface, nfd_v, 9)
    M_F[:, nfd_v: nfd_v + 2 * nss] = np.einsum(
        "jv,fdc->fjdvc", cjv_fac[:nss], W
    ).reshape(nface, 2 * nss, 9)
    return M_F, faces


def hybrid_h1_face_transfer(V, lay: FaceBlockLayout, dtype=torch.float32,
                            split_k: int = 1):
    """Face-layout P1 transfer for the skeleton coarse correction:
    ``TF (nv, 3) -> (nface, nfb)`` and its exact transpose ``TFt``.

    yF[f] = M_F[f] @ c[faces[f]] (:func:`face_transfer_table`)."""
    mesh = V.mesh
    nface = mesh.nface
    dev = lay.device
    M_F, faces = face_transfer_table(V, lay.nfb)

    MF_apply = make_table_apply(M_F, store_dtype=dtype, device=dev,
                                split_k=split_k, compute_dtype=dtype)
    MFt_apply = make_table_apply(
        np.ascontiguousarray(M_F.transpose(0, 2, 1)), store_dtype=dtype,
        device=dev, split_k=split_k, compute_dtype=dtype)

    # vertex accumulation plan for the transpose: (face, slot) pairs per
    # vertex, padded to the max valence (pad index -> appended zero row)
    nv = mesh.nv
    flat_v = faces.ravel()
    order = np.argsort(flat_v, kind="stable")
    counts = np.bincount(flat_v, minlength=nv)
    maxval = int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)])
    vs_idx = np.full((nv, maxval), 3 * nface, np.int64)
    for s in range(maxval):
        has = counts > s
        vs_idx[has, s] = order[starts[:-1][has] + s]
    faces_t = torch.as_tensor(faces.astype(np.int64), device=dev)
    vs_idx_t = torch.as_tensor(vs_idx, device=dev)

    def TF(z):
        """(nv, 3) coarse vertex values -> (nface, nfb) face-block rows."""
        return MF_apply(z[faces_t].reshape(nface, 9))

    def TFt(rF):
        g = MFt_apply(rF)  # (nface, 9)
        g3 = torch.cat([g.reshape(3 * nface, 3), g.new_zeros((1, 3))])
        return g3[vs_idx_t].sum(dim=1)  # (nv, 3)

    TF.table, TFt.table = MF_apply.table, MFt_apply.table
    return TF, TFt


def build_skeleton_preconditioner_3d(
    V, A_np: np.ndarray, velocity_dirichlet: str, device,
    dtype=torch.float32, coarse_coefficient: float = 1.0,
    dof_scale: np.ndarray | None = None, gs: bool = True,
    ext_dtype=torch.bfloat16, inv_dtype=torch.bfloat16,
    panel_dtype=torch.float32, sweep_dtype=torch.float32,
    coarse_target: float = 1.6, split_k: int = 1, symmetrize: bool = True,
):
    """Condensation-aware preconditioner for the condensed 3D MCS
    operator: exact batched solve of the element-interior block, the
    edge-star smoother on the skeleton Schur complement (symmetric
    multicolor GS with ``gs=True``, additive otherwise), and the vector-P1
    auxiliary-space coarse correction.

    ``A_np``: (ne, nb, nb) f64 element tables in FLAT element order
    (equilibrated when ``dof_scale`` = D is given: A~ = D A D, and the
    coarse transfer becomes D^{-1} T).  Table storage, by the JAX package's
    groups (``NSTPU_SMOOTHER_BF16``, refinement.py:383-412; defaults are
    bench.py's "ext,inv"): ``ext_dtype`` the extension and interior tables,
    ``inv_dtype`` the GS color-solve inverses, ``panel_dtype`` the GS row
    panels, ``sweep_dtype`` the skeleton table S and the additive edge-star
    inverses.  Arithmetic, and the coarse transfer, are ``dtype``: f32 for
    the flagship solve; f64 with all four groups f64 for the 3D model's own
    preconditioner (``NavierStokesMCS._preA_for``), whose f64 tables take
    the plain batched products of ``make_table_apply``'s f64 route.
    ``coarse_target``: the damping target of the multiplicative coarse
    correction (``NSTPU_COARSE_TARGET``; bench.py's 1.6, the JAX
    package's default 0.9).  ``split_k``
    (``NSTPU_SPLITK``): sub-tables of the split-k table applies.

    ``symmetrize`` (a departure from the JAX package, which stores its f64
    tables as computed): A_ii^{-1}, S and the edge-star inverses are
    averaged with their transposes before they are rounded to their
    storage dtypes, so that the stored tables -- and with them the GS sweep
    -- are exactly symmetric.  Unsymmetrized, f64 roundoff crossing
    rounding boundaries leaves ~1e-7 of asymmetry in f32 storage.
    ``False`` stores the reference's tables."""
    mesh = V.mesh
    nbv = V.hdiv.n_basis
    n_face_tot = 4 * V.hdiv.n_face_dofs
    nfac = V.facet.n_face * 4
    loc_int = np.arange(n_face_tot, nbv)
    loc_skel = np.concatenate(
        [np.arange(n_face_tot), np.arange(nbv, nbv + nfac)]
    )
    # interior Schur complement in f64 on the host (flat element order)
    sym = symmetric_part if symmetrize else (lambda a: a)
    A_ii = A_np[:, loc_int[:, None], loc_int[None, :]]
    A_is = A_np[:, loc_int[:, None], loc_skel[None, :]]
    A_ss = A_np[:, loc_skel[:, None], loc_skel[None, :]]
    A_ii_inv = sym(np.linalg.inv(A_ii))
    AinvAis = np.matmul(A_ii_inv, A_is)  # (ne, n_int, n_skel)
    S_loc = sym(A_ss - np.matmul(A_is.transpose(0, 2, 1), AinvAis))

    space = H1(mesh, 1, dirichlet=velocity_dirichlet)
    solve1 = coarse_p1_solver(space, coarse_coefficient, dtype, device)

    lay = FaceBlockLayout(V, device)
    TF, TFt = hybrid_h1_face_transfer(V, lay, dtype, split_k)
    tables = {"M_F": TF.table, "M_F^T": TFt.table}
    if dof_scale is None:
        def coarse_vc(rF):
            return TF(solve1(TFt(rF)))
    else:
        dinv = 1.0 / np.asarray(dof_scale)
        DinvF = torch.as_tensor(
            np.concatenate(
                [
                    dinv[: lay.off_c].reshape(lay.nface, lay.nfd_v),
                    dinv[lay.nhd:].reshape(lay.nface, lay.nfd_f),
                ],
                axis=1,
            ),
            device=device,
        ).to(dtype)

        def coarse_vc(rF):
            return DinvF * TF(solve1(TFt(DinvF * rF)))

    preA = _build_skeleton_fast(
        V, lay, AinvAis, A_ii_inv, S_loc, coarse_vc, dtype, gs=gs,
        ext_dtype=ext_dtype, inv_dtype=inv_dtype, panel_dtype=panel_dtype,
        sweep_dtype=sweep_dtype, coarse_target=coarse_target,
        split_k=split_k, symmetrize=symmetrize,
    )
    preA.parts["tables"].update(tables)
    # ELL levels of the coarse solve's AMG hierarchy (0: the dense inverse)
    preA.parts["coarse_amg_levels"] = getattr(solve1, "levels", 0)
    return preA


def _build_skeleton_fast(V, lay, AinvAis, A_ii_inv, S_loc, coarse_vc, cdt, gs,
                         ext_dtype, inv_dtype, panel_dtype, sweep_dtype,
                         coarse_target, split_k, symmetrize):
    """Face-block rendering of the skeleton preconditioner, every batched
    block matvec a table apply; ``cdt`` is the arithmetic dtype.
    ``preA.parts`` holds its components for per-part timings and, under
    ``"tables"``, the device table of every table apply it launches (per GS
    color: the panels and the solve table, a
    :class:`~navier_stokes_tpu_torch.ops.block_mv.SegmentTable`)."""
    dev = lay.device
    free = torch.as_tensor(V.free_mask, device=dev)
    S_perm_np = lay.permute_skel_blocks(S_loc)
    sm = face_star_smoother(lay, V.free_mask, cdt)
    freeF = sm.freeF
    # the f64 setup tables: passed to the smoother's build step, then dropped
    S5p = sm.skeleton_table(S_perm_np)
    invs = sm.bucket_inverses(S5p, symmetrize)

    AinvAis_perm = np.ascontiguousarray(AinvAis[:, :, lay.perm_skel])
    ext_apply = make_table_apply(AinvAis_perm, store_dtype=ext_dtype,
                                 device=dev, split_k=split_k,
                                 compute_dtype=cdt)
    extT_apply = make_table_apply(
        np.ascontiguousarray(AinvAis_perm.transpose(0, 2, 1)),
        store_dtype=ext_dtype, device=dev, split_k=split_k,
        compute_dtype=cdt)
    inner_apply = make_table_apply(A_ii_inv, store_dtype=ext_dtype,
                                   device=dev, split_k=split_k,
                                   compute_dtype=cdt)
    tables = {"ext": ext_apply.table, "ext^T": extT_apply.table,
              "inner": inner_apply.table}

    def ext_fb(yF):
        """Interiors from skeleton values (face layout)."""
        return -ext_apply(lay.gather_skel(yF))

    def extT_fb(xF, xi):
        """Fold interior residual into the skeleton (face layout)."""
        return xF + lay.scatter_skel(-extT_apply(xi))

    parts = {"ext": ext_fb, "extT": extT_fb, "layout": lay, "smoother": sm}
    if gs:
        S_elem_apply = make_table_apply(S_perm_np, store_dtype=sweep_dtype,
                                        device=dev, split_k=split_k,
                                        compute_dtype=cdt)
        tables["S"] = S_elem_apply.table

        def S_faces(xF):
            """Skeleton operator purely in face layout (free-masked)."""
            xF = torch.where(freeF, xF, 0.0)
            ye = S_elem_apply(lay.gather_skel(xF).contiguous())
            return torch.where(freeF, lay.scatter_skel(ye), 0.0)

        # color edge-stars so same-color blocks are operator-decoupled
        # (they must not touch a common element)
        nfb = lay.nfb
        t0 = time.perf_counter()
        blocks_fb = [(np.asarray(f)[:, None] * nfb
                      + np.arange(nfb)[None, :]).ravel()
                     for f in sm.block_faces]
        colors = color_blocks(blocks_fb, lay.nface * nfb, lay.eldofs_fb)
        t1 = time.perf_counter()
        groups = sm.color_row_groups(colors, S5p, invs, panel_dtype,
                                     inv_dtype)
        del S5p, invs
        t2 = time.perf_counter()
        for c, g in enumerate(groups):
            tables[f"GS color {c} panels"] = g.panels.table
            tables[f"GS color {c} solve"] = g.solve.table

        def coarse_faces(rF):
            return torch.where(freeF, coarse_vc(rF), 0.0)

        # the example vector of the JAX package (default_rng(7))
        rng = np.random.default_rng(7)
        exF = torch.as_tensor(rng.standard_normal((lay.nface, nfb)),
                              device=dev).to(cdt) * freeF
        coarse_gs, lam, theta = damped_coarse(coarse_faces, S_faces, exF,
                                              target=coarse_target)
        setup_seconds = {"coloring": t1 - t0, "row-panel groups": t2 - t1,
                         "coarse damping": time.perf_counter() - t2}

        def pre_skel_faces(xF):
            """Symmetric sweep: forward colors, the damped coarse
            correction on the residual, backward colors.  The iterate is
            row-major (nface+1, nfb) with one zero pad row."""
            zrow = xF.new_zeros((1, nfb))
            xP = torch.cat([xF, zrow])
            y = None  # zero iterate: the first color reads x directly
            for g in groups:
                dy = sm.solve_color_rows(g, xP, y)
                y = dy if y is None else y + dy
            yF = y[:-1]
            yF = yF + coarse_gs(xF - S_faces(yF))
            yP = torch.cat([yF, zrow])
            for g in reversed(groups):
                yP = yP + sm.solve_color_rows(g, xP, yP)
            return yP[:-1]

        parts.update(coarse_only=coarse_gs, S_faces=S_faces, groups=groups,
                     colors=colors, coarse_lambda=lam, coarse_theta=theta,
                     setup_seconds=setup_seconds)
    else:
        sm.build_additive(invs, sweep_dtype, split_k)
        del S5p, invs

        def pre_skel_faces(xF):
            yF = sm.smooth_faces(xF)
            return yF + torch.where(freeF, coarse_vc(xF), 0.0)

        parts.update(coarse_only=coarse_vc, smooth_only=sm.smooth_faces)
        for faces_b, solve in sm.buckets:
            tables[f"edge-star inv {faces_b.shape[1]} faces"] = solve.table

    def preA(x):
        xf = torch.where(free, x, 0.0)
        xF, xi = lay.split(xf)
        rF = torch.where(freeF, extT_fb(xF, xi.contiguous()), 0.0)
        yF = pre_skel_faces(rF)
        yi = ext_fb(yF) + inner_apply(xi)
        return torch.where(free, lay.join(yF, yi), x)

    # component probes (face-layout in/out) for per-part timings
    parts.update(pre_skel=pre_skel_faces, tables=tables)
    preA.parts = parts
    return preA


def hybrid_h1_embedding_3d(V, dtype=torch.float64, device=None):
    """(T, TT) for a HybridVelocitySpace3D; coarse vectors are (3*nv,)
    component-major.

    T embeds a continuous vector-P1 field: face dofs are moments of the
    linear field, facet dofs the frame coefficients of its tangential
    trace, interior dofs the per-element L2-optimal completion (exact on
    vector linears).  Both directions are padded-ELL gathers of the host
    assembled sparse T and its transpose, in ``dtype`` on ``device``."""
    device = resolve_device(device)
    mesh = V.mesh
    hd = V.hdiv
    k = hd.order
    nfd_v = hd.n_face_dofs
    nss = V.facet.n_scalar
    nfd_f = V.facet.n_face
    nv = mesh.nv
    nV = V.ndof

    cjv, cjv_fac, faces, nsc, W = _p1_face_moments(V)

    # ---- interior completion tables ----------------------------------
    n_int = hd.bases[0].n_cell
    nbv = hd.n_basis
    n_face_tot = 4 * nfd_v
    J, detJ, _ = mesh.element_jacobians
    vol = tetrahedron_rule(2 * k + 2)
    vals_ref, _ = hd.tabulate_elements(vol.points)  # (ne, nq, nb, 3)
    # the JAX package's quadrature sums as batched products over the
    # points: the Piola values J vhat, then one Gram product per element
    ne, nq = vals_ref.shape[:2]
    pv = piola_values(J, vals_ref)  # (ne, nq, nb, 3)
    pw = pv * (vol.weights[None, :, None, None] / detJ[:, None, None, None])
    Gm = np.matmul(pw.transpose(0, 2, 1, 3).reshape(ne, nbv, nq * 3),
                   pv.transpose(0, 1, 3, 2).reshape(ne, nq * 3, nbv))
    lam3 = np.concatenate(
        [1 - vol.points.sum(1, keepdims=True), vol.points], axis=1
    )  # (nq, 4)
    t_mat = np.matmul(
        pv.transpose(0, 2, 3, 1).reshape(ne, nbv * 3, nq),
        vol.weights[:, None] * lam3,
    ).reshape(ne, nbv, 12)  # (c, v) flattened c*4+v
    del pv, pw

    # S[e, local-face-dof, (c,v)]: global face moments from element vertex
    # values (vertex positions of each face's sorted-global vertices)
    els = mesh.elements
    S = np.zeros((mesh.ne, n_face_tot, 12))
    for lf in range(4):
        fid = mesh.element_faces[:, lf]
        gvert = faces[fid]  # (ne, 3) sorted global ids
        # position of each face vertex among the element's vertices
        pos = np.argmax(els[:, :, None] == gvert[:, None, :], axis=1)  # (ne,3)
        for j in range(nfd_v):
            for v in range(3):
                for c in range(3):
                    S[np.arange(mesh.ne), lf * nfd_v + j, c * 4 + pos[:, v]] += (
                        cjv[j, v] * nsc[fid, c]
                    )
    G_ii = Gm[:, n_face_tot:, n_face_tot:]
    G_ie = Gm[:, n_face_tot:, :n_face_tot]
    rhs_int = t_mat[:, n_face_tot:, :] - np.einsum(
        "eij,ejv->eiv", G_ie, S, optimize=True
    )
    M_int = np.linalg.solve(G_ii, rhs_int)  # (ne, n_int, 12)
    off_c = mesh.nface * nfd_v
    nface = mesh.nface
    ne = mesh.ne
    nhd = hd.ndof

    # ---- padded-ELL sparse transfer (host-assembled) -------------------
    # T is a FIXED sparse operator (<= 12 nnz per fine row: one face's 3
    # vertices x 3 components, or one element's 4 x 3), so both transfer
    # directions are gathers with row sums: no scatter.
    # part 1: hdiv face-moment rows  T[f*nfd_v+j, c*nv+faces[f,v]]
    #         = cjv[j,v] * nsc[f,c]
    r1 = (np.arange(nface)[:, None, None, None] * nfd_v
          + np.arange(nfd_v)[None, :, None, None])            # (f,j,1,1)
    c1 = (np.arange(3)[None, None, None, :] * nv
          + faces[:, None, :, None])                          # (f,1,v,c)
    v1 = (cjv[:nfd_v][None, :, :, None]
          * nsc[:, None, None, :])                            # (f,j,v,c)
    r1b, c1b, v1b = np.broadcast_arrays(r1, c1, v1)

    # part 2: facet frame rows  T[nhd+f*nfd_f+(j*2+d), c*nv+faces[f,v]]
    #         = cjv_fac[j,v] * W[f,d,c]
    r2 = (nhd + np.arange(nface)[:, None, None, None, None] * nfd_f
          + (np.arange(nss)[None, :, None, None, None] * 2
             + np.arange(2)[None, None, :, None, None]))      # (f,j,d,1,1)
    c2 = (np.arange(3)[None, None, None, None, :] * nv
          + faces[:, None, None, :, None])                    # (f,1,1,v,c)
    v2 = (cjv_fac[:nss][None, :, None, :, None]
          * W[:, None, :, None, :])                           # (f,j,d,v,c)
    r2b, c2b, v2b = np.broadcast_arrays(r2, c2, v2)

    # part 3: interior completion rows  T[off_c+e*n_int+i, c*nv+els[e,v]]
    #         = M_int[e,i,c*4+v]
    r3 = (off_c + np.arange(ne)[:, None, None, None] * n_int
          + np.arange(n_int)[None, :, None, None])            # (e,i,1,1)
    c3 = (np.arange(3)[None, None, :, None] * nv
          + els[:, None, None, :])                            # (e,1,c,v)
    v3 = M_int.reshape(ne, n_int, 3, 4)                       # (e,i,c,v)
    r3b, c3b, v3b = np.broadcast_arrays(r3, c3, v3)

    Tm = sp.coo_matrix(
        (
            np.concatenate([v1b.ravel(), v2b.ravel(), v3b.ravel()]),
            (
                np.concatenate([r1b.ravel(), r2b.ravel(), r3b.ravel()]),
                np.concatenate([c1b.ravel(), c2b.ravel(), c3b.ravel()]),
            ),
        ),
        shape=(nV, 3 * nv),
    ).tocsr()
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

def build_auxspace_preconditioner_3d(
    V, A_np, velocity_dirichlet: str, dtype=torch.float64,
    coarse_coefficient: float = 1.0, blocks: str = "vertexstar",
    gs: bool = False, A_apply=None, device=None,
):
    """Overlapping block smoother + vector-P1 coarse correction for the
    assembled [H(div) | facet] operator of the element tables ``A_np``, the
    3D counterpart of the reference's MypreA structure: additive,
    preA u = S u + T Kc^{-1} T^T u on the free dofs, with S the
    block-Jacobi over the free dofs of the :func:`~.stokes_hybrid3d.
    hybrid_blocks_3d` patches (``blocks``, vertex stars by default) and
    Kc the P1 stiffness times ``coarse_coefficient``
    (precond/twolevel.coarse_p1_solver).

    The block inverses are extracted and inverted on ``device`` in f64
    (precond/jacobi.block_inverses: the blocks rounded to ``dtype`` first,
    as the JAX model rounds them) and stored padded in ``dtype``; the
    apply is ``batched_local_matvec`` in f64 and ``block_mv`` in f32, the
    hand-written kernels on the card.  ``preA.table`` is the stored table.

    ``gs=True`` switches to the symmetric multicolor block-GS variant
    (MypreA.Mult with GS=True; precond/multicolor, its inverses taken on
    the host as the JAX package's) around the same coarse correction; it
    needs ``A_apply``, the masked operator."""
    device = resolve_device(device)
    mesh = V.mesh
    nV = V.ndof
    free = torch.as_tensor(V.free_mask, device=device)
    blks = free_blocks(V, blocks)
    dofs = padded_blocks(blks)
    A_csr = assemble_csr(np.asarray(A_np), V.element_dofs, nV)

    T, TT = hybrid_h1_embedding_3d(V, dtype, device)
    space = H1(mesh, 1, dirichlet=velocity_dirichlet)
    solve1 = coarse_p1_solver(space, coarse_coefficient, dtype,
                              device=device)
    nv = mesh.nv

    def coarse(r):
        rt = TT(r).reshape(3, nv).T
        return T(solve1(rt).T.reshape(-1))

    if gs:
        if A_apply is None:
            raise ValueError("gs=True needs the masked operator A_apply")
        colors = color_blocks(blks, nV, np.asarray(V.element_dofs))
        mgs = MulticolorGS(dofs, extract_blocks_csr(A_csr, dofs), colors,
                           nV, dtype, device)
        return symmetric_gs_preconditioner(mgs, A_apply, coarse, free)

    smooth = block_jacobi_inverses(
        dofs, block_inverses(A_csr, dofs, dtype, device), nV, dtype, device)

    def preA(u):
        uf = torch.where(free, u, 0.0)
        y = smooth(uf) + coarse(uf)
        return torch.where(free, y, u)

    preA.table = smooth.table
    return preA

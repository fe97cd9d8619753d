"""Skeleton preconditioner for the condensed 3D MCS operator.

Counterpart of ``navier_stokes_tpu/models/auxspace3d.py``, fast face-block
path:

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
GS panels and color solves).

The interior Schur complement and the edge-star inverses are computed in
f64 (host numpy, resp. torch f64 on the device) and cast to the storage
dtypes, as the JAX package's host path does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..fem.quadrature import triangle_rule
from ..fem.reference import triangle_modal
from ..fem.spaces import H1
from ..ops.block_mv import make_table_apply
from ..ops.faceblock import (
    FaceBlockLayout,
    face_star_smoother,
    symmetric_part,
)
from ..precond.multicolor import color_blocks, damped_coarse
from ..precond.twolevel import coarse_p1_solver

__all__ = ["hybrid_h1_face_transfer", "build_skeleton_preconditioner_3d"]


def hybrid_h1_face_transfer(V, lay: FaceBlockLayout, dtype=torch.float32,
                            split_k: int = 1):
    """Face-layout P1 transfer for the skeleton coarse correction:
    ``TF (nv, 3) -> (nface, nfb)`` and its exact transpose ``TFt``.

    yF[f] = M_F[f] @ c[faces[f]] with per-face dense maps from the face's
    3 vertices x 3 components (hdiv moment rows, then facet frame rows)."""
    mesh = V.mesh
    hd = V.hdiv
    k = hd.order
    nfd_v = hd.n_face_dofs
    nss = V.facet.n_scalar
    nface = mesh.nface
    nfb = lay.nfb
    dev = lay.device

    rule2 = triangle_rule(2 * max(k, V.facet.order) + 2)
    phi_v, _ = triangle_modal(rule2.points, k)
    phi_f, _ = triangle_modal(rule2.points, V.facet.order)
    lam2 = np.concatenate(
        [1 - rule2.points.sum(1, keepdims=True), rule2.points], axis=1
    )
    cjv = np.einsum("q,qj,qv->jv", rule2.weights, phi_v, lam2)
    cjv_fac = np.einsum("q,qj,qv->jv", rule2.weights, phi_f, lam2)

    pts = mesh.points
    faces = np.asarray(mesh.faces)
    fv = pts[faces]
    E1 = fv[:, 1] - fv[:, 0]
    E2 = fv[:, 2] - fv[:, 0]
    nsc = np.cross(E1, E2)
    E = np.stack([E1, E2], axis=1)  # (nface, 2, 3)
    G = np.einsum("fdc,fec->fde", E, E)
    W = np.einsum("fde,fec->fdc", np.linalg.inv(G), E)  # (nface, 2, 3)

    M_F = np.zeros((nface, nfb, 9))
    M_F[:, :nfd_v] = np.einsum(
        "jv,fc->fjvc", cjv[:nfd_v], nsc
    ).reshape(nface, nfd_v, 9)
    M_F[:, nfd_v: nfd_v + 2 * nss] = np.einsum(
        "jv,fdc->fjdvc", cjv_fac[:nss], W
    ).reshape(nface, 2 * nss, 9)

    MF_apply = make_table_apply(M_F, store_dtype=dtype, device=dev,
                                split_k=split_k)
    MFt_apply = make_table_apply(
        np.ascontiguousarray(M_F.transpose(0, 2, 1)), store_dtype=dtype,
        device=dev, split_k=split_k)

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
    inverses.  Arithmetic, and the coarse transfer, are ``dtype`` (f32).
    ``coarse_target``: the damping target of the multiplicative coarse
    correction (``NSTPU_COARSE_TARGET``; bench.py's 1.6).  ``split_k``
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
    color: the panels and the solve table)."""
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

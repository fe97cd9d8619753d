"""Navier-Stokes on the MCS discretization in 2D and 3D — the reference's
centerpiece and the flagship model.

Counterpart of ``navier_stokes_tpu/models/navier_stokes_mcs.py``, one class
for both dimensions as there: V = BDM_k H(div) velocity, tangential facet
velocity of order k-1, H(curl,div) stress sigma (triangles:
fem/hcurldiv.py, tets: fem/hcurldiv3d.py) and the vorticity multiplier W
(scalar in 2D, a vector in 3D), with sigma and W eliminated per element by
batched static condensation.  The condensed [H(div) | facet] operator A,
the pressure coupling B (L2 order k-1) and the pressure-mass
preconditioner preM are built here; element assembly and condensation run
once on the host in f64 numpy, the operator tables live on ``device`` in
the model's ``dtype`` (f64 unless asked).  In 3D the tables ship face-major
for the scatter-free face-block applies (ops/faceblock.py); in 2D the
applies are gather -> element product -> deterministic scatter
(ops/assembly.ScatterPlan), every square element product -- A, the mass,
M* and Mv -- through the hand-written ``batched_local_matvec``.

With ``geometry=`` (mesh/curved.curve_to_circle in 2D,
curve_to_cylinder_3d in 3D) the curved elements are assembled
isoparametrically: in 2D every element through the curved assembler, in 3D
the curved-layer rows as the bench's default order-3 curved cylinder.

The transient SIMPLE step (``make_step_fn``, ``DoTimeStep``, ``Project``,
``SolveInitial(timesteps=n)``): explicit upwind-DG convection
(ops/convection3d.py), the implicit M* = M + dt A solve by Jacobi-
preconditioned CG, and the divergence projection by CG on
S = B Mv^-1 B^T with a Chebyshev mass inverse and the element-block + P1
two-level preconditioner.  Every square per-element product of the step --
the mass and condensed-operator applies and the element-block Jacobi --
goes through ``ops.local_mv.batched_local_matvec``, the hand-written kernel
on the card; ``A`` and ``A_raw`` stay plain tensor operations (the
flagship's true-residual check is independent of every kernel).  The mass
table, the Chebyshev bounds, the projection preconditioner and the
convection tables are built lazily: the steady solve never touches them.

The model's own initial Stokes solve, ``SolveInitial()``: Bramble-Pasciak
CG (solvers/bpcg.py, the optimized v2) in the model's precision with one of
the JAX model's A-preconditioners (``preconditioner=`` and ``GS=``).  3D:
the skeleton preconditioner (models/auxspace3d.py) at f64, its additive or
multicolor-GS variant, or the face blocks of the hybrid space, additive
(``build_faceblock_preconditioner_3d``) or multicolor block-GS
(precond/multicolor.MulticolorGS).  2D: ``jacobi``, ``edgeblock``,
``vertexstar`` or ``auxspace`` (vertex stars + vector-P1 coarse), additive
or multicolor block-GS (models/stokes_hybrid.build_hybrid_preconditioner),
the f64 star blocks through ``batched_local_matvec``.  The bench's flagship solve is
``flagship.FlagshipSolve``.  Enclosed flow (``outflow=""``) demeans the
pressure; ``AddForce`` / ``volumeforce`` load the right-hand side, and
``reconstruct_stress`` recovers the eliminated fields per element.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..fem.hcurldiv import hcurldiv_triangle
from ..fem.hcurldiv3d import hcurldiv_tet
from ..fem.hdiv import HDiv, VectorFacet, legendre_01
from ..fem.hdiv3d import HDiv3D
from ..fem.quadrature import tetrahedron_rule, triangle_rule
from ..fem.reference import TET_FACES, TET_VERTICES, triangle_modal
from ..fem.spaces import H1, L2
from ..mesh.curved import geometry_hessian, geometry_tables
from ..ops.assembly import ScatterPlan, apply_local_matrices, mass_diagonal
from ..ops.convection import build_upwind_convection
from ..ops.convection3d import build_upwind_convection_3d
from ..ops.faceblock import FaceBlockLayout
from ..ops.facets import facet_geometry
from ..ops.facets3d import facet_geometry_3d
from ..ops.local_mv import batched_local_matvec
from ..precond.chebyshev import chebyshev_preconditioner
from ..precond.jacobi import extract_blocks_from_local
from ..precond.multicolor import (
    MulticolorGS,
    color_blocks,
    symmetric_gs_preconditioner,
)
from ..precond.twolevel import coarse_p1_solver
from ..solvers.bpcg import bp_scale_factor, bramble_pasciak_cg_opt
from ..solvers.cg import cg
from ..utils.timers import Timer
from ..utils.tracing import traced
from .auxspace3d import build_skeleton_preconditioner_3d
from .stokes_hybrid import (
    A_PRECONDITIONERS,
    HybridVelocitySpace,
    build_hybrid_preconditioner,
    interpolate_hybrid_boundary,
)
from .stokes_hybrid3d import (
    HybridVelocitySpace3D,
    VectorFacet3D,
    build_faceblock_preconditioner_3d,
    free_blocks,
    interpolate_hybrid_boundary_3d,
)

__all__ = ["NavierStokesMCS", "load_host_tables"]

_CACHE_KEYS = {"tabs3d": 5, "cond": 2, "tabs3d_curved": 5, "cond_curved": 2}


def _assemble_mcs_ns_local(mesh, V, facet_space, sigma_basis, W_space, nu):
    """Element-local 4-field matrices, split into retained [u | uhat] and
    eliminated [sigma | W] blocks.

    Returns (A_ret, A_rc, A_cc, A_cr) with shapes over
    n_ret = nbv + 3*nfd and n_el = nbs + nbw, signs folded on the retained
    and eliminated sides.
    """
    hb, sb = V.basis, sigma_basis
    k = hb.order
    nbv, nbs = hb.n_basis, sb.n_basis
    nfd = facet_space.n_edge
    nfac = 3 * nfd
    qb = W_space.basis
    nbw = qb.n_basis

    J, detJ, Jinv = mesh.element_jacobians
    ne = mesh.ne
    vol = triangle_rule(2 * k + 2)
    w = vol.weights

    v_val, v_grad = hb.tabulate(vol.points)
    s_val, s_grad = sb.tabulate(vol.points)
    w_val, _ = qb.tabulate(vol.points)

    # physical sigma and its divergence (see stokes_mcs.py derivation)
    sp = np.einsum("eai,qnab,ejb->eqnij", Jinv, s_val, J, optimize=True) / detJ[:, None, None, None, None]
    div_s_ref = np.einsum("qnabb->qna", s_grad)
    v_p = np.einsum("ecA,qiA->eqic", J, v_val, optimize=True) / detJ[:, None, None, None]

    n_ret = nbv + nfac
    n_el = nbs + nbw
    A_ret = np.zeros((ne, n_ret, n_ret))
    A_rc = np.zeros((ne, n_ret, n_el))
    A_cc = np.zeros((ne, n_el, n_el))

    # -(1/(2 nu)) sigma:tau
    A_cc[:, :nbs, :nbs] += -(0.5 / nu) * np.einsum(
        "q,eqnij,eqmij,e->enm", w, sp, sp, detJ
    , optimize=True)
    # vorticity multiplier: W skw(tau) + R skw(sigma); skw(m) = m10 - m01
    skw_s = sp[..., 1, 0] - sp[..., 0, 1]  # (ne, nq, nbs)
    wr = np.einsum("q,qn,eqm,e->enm", w, w_val, skw_s, detJ, optimize=True)
    A_cc[:, nbs:, :nbs] += wr
    A_cc[:, :nbs, nbs:] += wr.transpose(0, 2, 1)
    # div(sigma).v + div(tau).u  (ref-frame pairing / detJ)
    dsv = np.einsum("q,qma,qia,e->eim", w, div_s_ref, v_val, 1.0 / detJ, optimize=True)
    A_rc[:, :nbv, :nbs] += dsv
    # facet terms
    fg = facet_geometry(mesh, k + 3)
    for le in range(3):
        pts = fg.ref_points[le]
        tv, _ = hb.tabulate(pts)
        ts, _ = sb.tabulate(pts)
        v_tp = np.einsum("ecA,qiA->eqic", J, tv, optimize=True) / detJ[:, None, None, None]
        s_tp = np.einsum("eai,qnab,ejb->eqnij", Jinv, ts, J, optimize=True) / detJ[:, None, None, None, None]
        nrm = fg.normal[:, le]
        vn = np.einsum("eqic,ec->eqi", v_tp, nrm, optimize=True)
        sn = np.einsum("eqnij,ej->eqni", s_tp, nrm, optimize=True)
        snn = np.einsum("eqni,ei->eqn", sn, nrm, optimize=True)
        ds = fg.elen[:, le]
        # -(sigma n.n)(v.n)
        blk = np.einsum("q,eqm,eqi,e->eim", fg.w, snn, vn, ds, optimize=True)
        A_rc[:, :nbv, :nbs] -= blk
        # -(sigma n).tang(uhat): facet basis = L_j(t_g) tau_g (tangential)
        tgl = fg.t_global[:, le]
        leg = np.stack([legendre_01(tgl, j) for j in range(nfd)], axis=2)
        fvals = leg[..., None] * fg.tau_global[:, le][:, None, None, :]
        sn_t = sn - snn[..., None] * nrm[:, None, None, :]
        blk2 = np.einsum("q,eqmc,eqjc,e->ejm", fg.w, sn_t, fvals, ds, optimize=True)
        A_rc[:, nbv + le * nfd: nbv + (le + 1) * nfd, :nbs] -= blk2

    # grad-div: 2 nu div(u) div(v)
    div_v_ref = np.einsum("qnaa->qn", v_grad)
    A_ret[:, :nbv, :nbv] += 2.0 * nu * np.einsum(
        "q,qn,qm,e->enm", w, div_v_ref, div_v_ref, 1.0 / detJ
    , optimize=True)

    # fold signs: retained = [hdiv signs | +1 facet], eliminated = [sigma
    # parity signs | +1]
    s_ret = np.concatenate(
        [V.element_signs, np.ones((ne, nfac))], axis=1
    )
    # sigma element-local -> no sharing, signs irrelevant (identity)
    A_ret = A_ret * s_ret[:, :, None] * s_ret[:, None, :]
    A_rc = A_rc * s_ret[:, :, None]
    return A_ret, A_rc, A_cc, v_p, vol


def _mcs_mass_coupling_2d(mesh, V, Q_basis, v_p, vol, n_ret):
    """The affine 2D velocity mass on the retained block (u block only,
    signs folded) and the pressure coupling B_loc (pressure x retained):
    int div(u) q dx = sum_q w divhat q -- the Piola divergence and detJ
    cancel, so B is one reference-frame block for every element, up to
    signs."""
    nbv = V.basis.n_basis
    sv = v_p * V.element_signs[:, None, :, None]
    M_u = np.einsum("q,eqic,eqjc,e->eij", vol.weights, sv, sv,
                    mesh.element_jacobians[1], optimize=True)
    M_full = np.zeros((mesh.ne, n_ret, n_ret))
    M_full[:, :nbv, :nbv] = M_u
    q_val, _ = Q_basis.tabulate(vol.points)
    _, v_grad = V.basis.tabulate(vol.points)
    div_v_ref = np.einsum("qnaa->qn", v_grad)
    B_loc = np.zeros((mesh.ne, Q_basis.n_basis, n_ret))
    B_ref = np.einsum("q,qp,qi->pi", vol.weights, q_val, div_v_ref,
                      optimize=True)
    B_loc[:, :, :nbv] = B_ref[None] * V.element_signs[:, None, :]
    return M_full, B_loc


def _assemble_mcs_ns_local_curved(mesh, V, facet_space, sigma_basis,
                                  W_space, nu, geometry):
    """Curved-geometry (isoparametric) 2D MCS assembly (VERDICT round-2
    item 5: the reference curves the cylinder for every benchmark,
    run.py:28 / NavierStokesSIMPLE_test.py:12).

    With a non-affine map the stress pullback sigma = (1/detJ) J^{-T}
    sigmahat J^T acquires curvature terms in its divergence:

      d_B sigma_ij = (1/detJ) [ (d_B Jinv)_ai shat_ab J_jb
                                + Jinv_ai ghat_abB J_jb
                                + Jinv_ai shat_ab H_jbB ]
                     - (d_B detJ / detJ^2) Jinv_ai shat_ab J_jb,
      (div sigma)_i = d_B sigma_ij Jinv_Bj,
      (d_B Jinv)_ai = - Jinv_ac H_cdB Jinv_di,

    while ``div u = divhat/detJ`` (H(div) Piola identity) keeps the
    grad-div and pressure-coupling terms curvature-free.  Facet integrals
    use the exact curved scaled normal detJ J^{-T} nhat.  Returns
    (A_ret, A_rc, A_cc, M_full, B_loc) with signs folded like the affine
    2D path.
    """
    hb, sb = V.basis, sigma_basis
    k = hb.order
    nbv, nbs = hb.n_basis, sb.n_basis
    nfd = facet_space.n_edge
    nfac = 3 * nfd
    qb = W_space.basis
    nbw = qb.n_basis
    ne = mesh.ne

    vol = triangle_rule(2 * k + 4)
    w = vol.weights
    J, detJ, Jinv, xq = geometry_tables(geometry, vol.points)
    H = geometry_hessian(geometry, vol.points)
    ddet = (
        H[..., 0, 0, :] * J[..., 1, 1, None]
        + J[..., 0, 0, None] * H[..., 1, 1, :]
        - H[..., 0, 1, :] * J[..., 1, 0, None]
        - J[..., 0, 1, None] * H[..., 1, 0, :]
    )  # (ne, nq, 2B)
    dJinv = -np.einsum(
        "eqac,eqcdB,eqdi->eqaiB", Jinv, H, Jinv, optimize=True
    )

    v_val, v_grad = hb.tabulate(vol.points)
    s_val, s_grad = sb.tabulate(vol.points)
    w_val, _ = qb.tabulate(vol.points)

    n_ret = nbv + nfac
    n_el = nbs + nbw
    A_ret = np.zeros((ne, n_ret, n_ret))
    A_rc = np.zeros((ne, n_ret, n_el))
    A_cc = np.zeros((ne, n_el, n_el))

    # physical stress values
    sp = np.einsum(
        "eqai,qnab,eqjb->eqnij", Jinv, s_val, J, optimize=True
    ) / detJ[..., None, None, None]
    A_cc[:, :nbs, :nbs] += -(0.5 / nu) * np.einsum(
        "q,eqnij,eqmij,eq->enm", w, sp, sp, detJ, optimize=True
    )
    skw_s = sp[..., 1, 0] - sp[..., 0, 1]
    wr = np.einsum("q,qn,eqm,eq->enm", w, w_val, skw_s, detJ, optimize=True)
    A_cc[:, nbs:, :nbs] += wr
    A_cc[:, :nbs, nbs:] += wr.transpose(0, 2, 1)

    # div(sigma) with curvature terms
    T = (
        np.einsum("eqaiB,qnab,eqjb->eqnijB", dJinv, s_val, J, optimize=True)
        + np.einsum("eqai,qnabB,eqjb->eqnijB", Jinv, s_grad, J, optimize=True)
        + np.einsum("eqai,qnab,eqjbB->eqnijB", Jinv, s_val, H, optimize=True)
    ) / detJ[..., None, None, None, None]
    T -= sp[..., None] * (ddet / detJ[..., None])[:, :, None, None, None, :]
    div_s = np.einsum("eqnijB,eqBj->eqni", T, Jinv, optimize=True)
    del T
    # pairing with v_phys * detJ = J vhat
    Jv = np.einsum("eqcA,qnA->eqnc", J, v_val, optimize=True)
    A_rc[:, :nbv, :nbs] += np.einsum(
        "q,eqmi,eqni->enm", w, div_s, Jv, optimize=True
    )

    # facet terms (curved normals)
    fg = facet_geometry(mesh, k + 4)
    ref_n_sc = {
        0: np.array([0.0, -1.0]),
        1: np.array([1.0, 1.0]),
        2: np.array([-1.0, 0.0]),
    }
    for le in range(3):
        pts = fg.ref_points[le]
        Jf, detf, Jinvf, _ = geometry_tables(geometry, pts)
        tv, _ = hb.tabulate(pts)
        ts, _ = sb.tabulate(pts)
        v_tp = np.einsum(
            "eqcA,qiA->eqic", Jf, tv, optimize=True
        ) / detf[..., None, None]
        s_tp = np.einsum(
            "eqai,qnab,eqjb->eqnij", Jinvf, ts, Jf, optimize=True
        ) / detf[..., None, None, None]
        nsc = np.einsum(
            "eq,eqBc,B->eqc", detf, Jinvf, ref_n_sc[le], optimize=True
        )
        dsq = np.linalg.norm(nsc, axis=-1)
        n_unit = nsc / dsq[..., None]
        vn = np.einsum("eqic,eqc->eqi", v_tp, n_unit, optimize=True)
        sn = np.einsum("eqnij,eqj->eqni", s_tp, n_unit, optimize=True)
        snn = np.einsum("eqni,eqi->eqn", sn, n_unit, optimize=True)
        blk = np.einsum("q,eqm,eqi,eq->eim", fg.w, snn, vn, dsq, optimize=True)
        A_rc[:, :nbv, :nbs] -= blk
        tgl = fg.t_global[:, le]
        leg = np.stack([legendre_01(tgl, j) for j in range(nfd)], axis=2)
        fvals = leg[..., None] * fg.tau_global[:, le][:, None, None, :]
        sn_t = sn - snn[..., None] * n_unit[:, :, None, :]
        blk2 = np.einsum(
            "q,eqmc,eqjc,eq->ejm", fg.w, sn_t, fvals, dsq, optimize=True
        )
        A_rc[:, nbv + le * nfd: nbv + (le + 1) * nfd, :nbs] -= blk2

    # grad-div (Piola identity: div u = divhat/detJ)
    div_v_ref = np.einsum("qnaa->qn", v_grad)
    A_ret[:, :nbv, :nbv] += 2.0 * nu * np.einsum(
        "q,qn,qm,eq->enm", w, div_v_ref, div_v_ref, 1.0 / detJ, optimize=True
    )

    # signs
    s_ret = np.concatenate([V.element_signs, np.ones((ne, nfac))], axis=1)
    A_ret = A_ret * s_ret[:, :, None] * s_ret[:, None, :]
    A_rc = A_rc * s_ret[:, :, None]

    # velocity mass on the retained block: u.v dx = vhat^T (J^T J) vhat/detJ
    G = np.einsum("eqca,eqcb->eqab", J, J, optimize=True)
    M_u = np.einsum(
        "q,qia,eqab,qjb,eq->eij", w, v_val, G, v_val, 1.0 / detJ,
        optimize=True,
    )
    M_u *= V.element_signs[:, :, None] * V.element_signs[:, None, :]
    M_full = np.zeros((ne, n_ret, n_ret))
    M_full[:, :nbv, :nbv] = M_u

    # pressure coupling (exact Piola identity, element-independent frame)
    q_val, _ = W_space.basis.tabulate(vol.points)
    B_ref = np.einsum("q,qp,qi->pi", w, q_val, div_v_ref, optimize=True)
    B_loc = np.zeros((ne, q_val.shape[1], n_ret))
    B_loc[:, :, :nbv] = B_ref[None] * V.element_signs[:, None, :]
    return A_ret, A_rc, A_cc, M_full, B_loc


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
    from ..mesh.curved import geometry_hessian_3d, geometry_tables_3d

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


def load_host_tables(arrays: dict) -> dict:
    """Host assembly tables of a model build, as an ``assembly_cache`` for
    :class:`NavierStokesMCS`.

    ``arrays`` holds numpy arrays under ``tabs3d`` = (A_ret, A_rc, A_cc,
    M_full, B_loc) and ``cond`` = (Acc_inv, A_cond) -- either as tuples or
    flattened as ``tabs3d_0`` ... ``tabs3d_4``, ``cond_0``, ``cond_1`` (the
    layout of the JAX package's assembly cache and of bench.py's on-disk
    cache).  A curved-geometry build reads ``tabs3d_curved`` and
    ``cond_curved`` instead (bench.py:139-141).  The model then builds from
    exactly these tables.

    State carried across: ``u`` and ``p`` (dof vectors of another model of
    the same spaces) and ``cheb_bounds`` = (alpha, beta) of its Chebyshev
    mass inverse, where present, go into a ``state`` entry that the model
    takes up at construction (:meth:`NavierStokesMCS.load_state`).  A 2D
    model has no table keys (the JAX 2D model caches none): its entry is
    the state alone, and the condensation (``cond``) where given."""
    out = {}
    state = {k: np.asarray(arrays[k], np.float64)
             for k in ("u", "p", "cheb_bounds") if k in arrays}
    if state:
        out["state"] = state
    for key, n in _CACHE_KEYS.items():
        if key in arrays:
            tup = tuple(arrays[key])
        elif all(f"{key}_{i}" in arrays for i in range(n)):
            tup = tuple(arrays[f"{key}_{i}"] for i in range(n))
        else:
            continue
        if len(tup) != n:
            raise ValueError(f"{key}: expected {n} arrays, got {len(tup)}")
        out[key] = tuple(np.asarray(a, np.float64) for a in tup)
    if not out:
        raise ValueError(f"no assembly tables or state among {sorted(arrays)}")
    return out


class NavierStokesMCS:
    """MCS model on triangles or tets (``mesh.dim``): spaces, condensed
    operators, the initial-solve right-hand side and the transient SIMPLE
    step.

    ``device``: where the operator tables live; CUDA unless the caller
    passes ``device="cpu"``.  ``dtype``: the model's working precision
    (tables, state and every operator): float64, or float32 for a stepping
    model as the bench's transient metric (the flagship initial solve needs
    the float64 model).  ``geometry``: a
    :class:`~navier_stokes_tpu_torch.mesh.curved.CurvedGeometry` (2D) or
    ``CurvedGeometry3D`` whose curved elements are assembled
    isoparametrically (None: straight).
    ``assembly_cache``: a dict (see :func:`load_host_tables`) whose
    ``tabs3d`` / ``cond`` entries (``tabs3d_curved`` / ``cond_curved`` with
    a geometry) replace host assembly and condensation; filled in when they
    are missing, so that a second model of the same mesh, order and nu
    (the f32 stepping twin of an f64 model) skips both.
    The 2D model caches only the condensation (``cond``), as the JAX one.
    ``preconditioner``: the A-preconditioner of ``SolveInitial`` and
    ``preA``; 3D: ``"auxspace"`` (the skeleton preconditioner) or
    ``"faceblock"``; 2D: ``"jacobi"``, ``"edgeblock"``, ``"vertexstar"`` or
    ``"auxspace"``.  ``volumeforce``: a callable (points (N, dim) ->
    (N, dim)) loaded into ``f`` by :meth:`AddForce`.  ``outflow=""``: enclosed flow,
    the constant pressure deflated from B, B^T and preM."""

    def __init__(self, mesh, nu: float, inflow: str, outflow: str,
                 wall: str, uin, timestep: float, order: int = 2,
                 volumeforce=None, dtype=torch.float64,
                 preconditioner: str = "auxspace", geometry=None,
                 assembly_cache: dict | None = None, device=None):
        if mesh.dim not in (2, 3):
            raise ValueError(f"mesh of dimension {mesh.dim}")
        if dtype not in (torch.float64, torch.float32):
            raise TypeError(f"dtype {dtype} is neither float64 nor float32")
        pre_ok = (A_PRECONDITIONERS if mesh.dim == 2
                  else ("auxspace", "faceblock"))
        if preconditioner not in pre_ok:
            raise ValueError(f"unknown preconditioner {preconditioner!r} in "
                             f"{mesh.dim}D: one of {pre_ok}")
        self.device = dev = resolve_device(device)
        self.dtype = dtype
        self.nu, self.timestep, self.uin = nu, timestep, uin
        self.inflow, self.outflow, self.wall = inflow, outflow, wall
        self.mesh, self.order = mesh, order
        self.preconditioner = preconditioner

        dirich = inflow + "|" + wall
        self._dirich = dirich
        self.Wspace = L2(mesh, order - 1)
        self.Q = L2(mesh, order - 1)
        self.geometry = geometry
        if mesh.dim == 2:
            A_ret, A_rc, A_cc, M_full_np, B_loc_np = self._spaces_2d(
                dirich, geometry)
        else:
            A_ret, A_rc, A_cc, M_full_np, B_loc_np = self._spaces_3d(
                dirich, geometry, assembly_cache)
        # static condensation: batched dense elimination of (sigma, W)
        ckey = "cond" if geometry is None else "cond_curved"
        if assembly_cache is not None and ckey in assembly_cache:
            self._Acc_inv, self.A_cond_np = assembly_cache[ckey]
        else:
            self._Acc_inv = np.linalg.inv(A_cc)
            self.A_cond_np = A_ret - np.einsum(
                "eic,ecd,ejd->eij", A_rc, self._Acc_inv, A_rc, optimize=True
            )
            if assembly_cache is not None:
                assembly_cache[ckey] = (self._Acc_inv, self.A_cond_np)
        self.B_loc_np = np.asarray(B_loc_np)
        self._M_loc_np = np.asarray(M_full_np)
        self._A_rc = A_rc  # for stress reconstruction

        n = self.Xv.ndof
        self.n = n
        self.free_np = self.Xv.free_mask
        self.free = free = torch.as_tensor(self.free_np, device=dev)

        def ship(a):
            return torch.as_tensor(a, device=dev).to(dtype)

        self._M_loc_t = None  # velocity mass table, shipped at first use
        if mesh.dim == 3:
            # scatter-free face-block applies; element tables ship
            # face-major
            self.fb = FaceBlockLayout(self.Xv, dev)
            self._A_cond = ship(self.fb.permute_blocks(self.A_cond_np))
            self._B_perm = ship(self.fb.permute_cols(self.B_loc_np))
            _A_apply = self.fb.elem_apply(self._A_cond)
            # the transient step's route: the same table through the kernel
            _A_step = self.fb.elem_apply(self._A_cond, use_kernel=True)
            _B_apply, _BT_apply = self.fb.rect_apply(self._B_perm,
                                                      self.Q.element_dofs)

            def A_raw(u):
                return _A_apply(u)

            def mass_raw(u):
                return self.fb.elem_apply(self._M_loc, use_kernel=True)(u)

            def B_raw(u):
                return _B_apply(u)

            def BT(p):
                return torch.where(free, _BT_apply(p), 0.0)
        else:
            # gather -> element product -> deterministic scatter; every
            # square element product through the kernel
            self.fb = None
            self._A_cond = ship(self.A_cond_np).contiguous()
            B_loc_t = ship(self.B_loc_np)
            plan_v = ScatterPlan(torch.as_tensor(
                self.Xv.element_dofs.astype(np.int64), device=dev), n)
            plan_p = ScatterPlan(torch.as_tensor(
                self.Q.element_dofs.astype(np.int64), device=dev),
                self.Q.ndof)

            def A_raw(u):
                return apply_local_matrices(self._A_cond, plan_v, n, u,
                                            use_kernel=True)

            _A_step = A_raw

            def mass_raw(u):
                return apply_local_matrices(self._M_loc, plan_v, n, u,
                                            use_kernel=True)

            def B_raw(u):
                return plan_p(torch.einsum("epi,ei->ep", B_loc_t,
                                           u[plan_v.index]))

            def BT(p):
                ue = torch.einsum("epi,ep->ei", B_loc_t, p[plan_p.index])
                return torch.where(free, plan_v(ue), 0.0)

        def A(u):
            uf = torch.where(free, u, 0.0)
            return torch.where(free, A_raw(uf), u)

        def mstar(u):
            uf = torch.where(free, u, 0.0)
            y = mass_raw(uf) + timestep * _A_step(uf)
            return torch.where(free, y, u)

        def B(u):
            return B_raw(torch.where(free, u, 0.0))

        self.A, self.A_raw, self.mstar = A, A_raw, mstar
        self.B, self.B_raw, self.BT = B, B_raw, BT
        self._A_raw_step, self._mass_raw = _A_step, mass_raw

        eld = self.Xv.element_dofs.ravel()
        diag_m_np = np.zeros(n)
        np.add.at(diag_m_np, eld, np.einsum(
            "eii->ei", self._M_loc_np + timestep * self.A_cond_np).ravel())
        diag_m = torch.where(free, ship(diag_m_np).abs(), 1.0)
        self.preMstar = lambda u: torch.where(free, u / diag_m, u)

        self._diag_Mp = mass_diagonal(self.Q)
        diag_Mp = ship(self._diag_Mp)
        if not outflow:
            # enclosed flow: deflate the constant-pressure nullspace
            def demean(p):
                return p - torch.mean(p)

            self.B = lambda u: demean(B(u))
            self.B_raw = lambda u: demean(B_raw(u))
            self.BT = lambda p: BT(demean(p))
            self.preM = lambda p: nu * demean(demean(p) / diag_Mp)
        else:
            self.preM = lambda p: nu * p / diag_Mp
        diag_Mv_np = np.zeros(n)
        np.add.at(diag_Mv_np, eld,
                  np.einsum("eii->ei", self._M_loc_np).ravel())
        diag_Mv = ship(diag_Mv_np)
        diag_Mv = torch.where(free & (diag_Mv.abs() > 1e-30), diag_Mv, 1.0)
        self._preMv = lambda u: torch.where(free, u / diag_Mv, u)

        # mass (masked, identity off the u block) for projection solves
        umask = torch.arange(n, device=dev) < self.V.ndof
        self._umask = umask
        fu = free & umask

        def Mv(u):
            y = mass_raw(torch.where(fu, u, 0.0))
            return torch.where(fu, y, u)

        self._Mv = Mv

        self._uin_np = self._wrap_uin(uin)
        self._conv_v = None
        self._mass_cheb = None
        self._pre_proj2 = None
        self.setup_seconds = {}  # lazy transient setup, seconds per piece
        self.last_iterations = {}  # CG counts of the last mstar / project
        self._preA_cache = {}

        # rhs + state
        self.f = torch.zeros(n, dtype=dtype, device=dev)
        if volumeforce is not None:
            self.AddForce(volumeforce)
        interp = (interpolate_hybrid_boundary if mesh.dim == 2
                  else interpolate_hybrid_boundary_3d)
        u_bc = interp(self.Xv, self._uin_np, inflow)
        self.u_bc = ship(u_bc)
        self.u = self.u_bc
        self.p = torch.zeros(self.Q.ndof, dtype=dtype, device=dev)
        self.stokes_bpcg_iterations = None
        self.stokes_bpcg_time = None
        self.stokes_bpcg_scale_k = None
        if assembly_cache is not None and "state" in assembly_cache:
            self.load_state(**assembly_cache["state"])

    # ------------------------------------------------------------------

    def _spaces_2d(self, dirich, geometry):
        """The triangle spaces and the host tables (A_ret, A_rc, A_cc,
        M_full, B_loc) of the 2D model: BDM_k, the order k-1 tangential
        facet space, the trace-free stress with nt-trace degree k-1."""
        mesh, order, nu = self.mesh, self.order, self.nu
        self.V = HDiv(mesh, order, dirichlet=dirich, RT=False)
        self.Vhat = VectorFacet(
            mesh, order - 1, dirichlet=dirich + "|" + self.outflow)
        self.Xv = HybridVelocitySpace(self.V, self.Vhat)
        self.sigma_basis = hcurldiv_triangle(order, order_trace=order - 1)
        if geometry is not None:
            return _assemble_mcs_ns_local_curved(
                mesh, self.V, self.Vhat, self.sigma_basis, self.Wspace, nu,
                geometry)
        A_ret, A_rc, A_cc, v_p, vol = _assemble_mcs_ns_local(
            mesh, self.V, self.Vhat, self.sigma_basis, self.Wspace, nu)
        M_full, B_loc = _mcs_mass_coupling_2d(
            mesh, self.V, self.Q.basis, v_p, vol, A_ret.shape[1])
        return A_ret, A_rc, A_cc, M_full, B_loc

    def _spaces_3d(self, dirich, geometry, assembly_cache):
        """The tet spaces and the host tables of the 3D model, from
        ``assembly_cache`` where it holds them."""
        mesh, order, nu = self.mesh, self.order, self.nu
        self.V = HDiv3D(mesh, order, dirichlet=dirich)
        self.Vhat = VectorFacet3D(
            mesh, order - 1, dirichlet=dirich + "|" + self.outflow)
        self.Xv = HybridVelocitySpace3D(self.V, self.Vhat)
        self.sigma_basis = hcurldiv_tet(order, order_trace=order - 1)
        tkey = "tabs3d" if geometry is None else "tabs3d_curved"
        if assembly_cache is not None and tkey in assembly_cache:
            return assembly_cache[tkey]
        tabs = _assemble_mcs_ns_local_3d(
            mesh, self.V, self.Vhat, self.sigma_basis, self.Wspace.basis,
            self.Q.basis, nu)
        if geometry is not None:
            # isoparametric overwrite of the curved-layer rows
            _assemble_mcs_ns_local_curved_3d(
                self.V, self.Vhat, self.sigma_basis, self.Wspace.basis,
                self.Q.basis, nu, geometry, *tabs)
        if assembly_cache is not None:
            assembly_cache[tkey] = tabs
        return tabs

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

    @property
    def _M_loc(self):
        """The face-major velocity mass table on the device, shipped at
        first use (the steady solve never touches it)."""
        if self._M_loc_t is None:
            M = self._M_loc_np
            if self.fb is not None:
                M = self.fb.permute_blocks(M)
            self._M_loc_t = torch.as_tensor(
                M, device=self.device).to(self.dtype).contiguous()
        return self._M_loc_t

    def _timed(self, key, build):
        t0 = time.perf_counter()
        out = build()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_seconds[key] = time.perf_counter() - t0
        return out

    def _build_convection(self):
        """Materialize the convection tables (the largest setup artifact;
        built lazily because the steady solve never needs them)."""
        if self._conv_v is None:
            build = (build_upwind_convection if self.mesh.dim == 2
                     else build_upwind_convection_3d)
            self._conv_v = self._timed(
                "convection", lambda: build(
                    self.V, self._uin_np, dtype=self.dtype,
                    device=self.device))
        return self._conv_v

    @traced("convection")
    def convection(self, u):
        conv = self._build_convection()
        nhd = self.V.ndof
        return torch.cat([conv(u[:nhd]), u.new_zeros(self.n - nhd)])

    def _wrap_uin(self, uin):
        dim = self.mesh.dim

        def f(p):
            out = np.asarray(uin(p))
            if out.ndim == 1:
                full = np.zeros((len(p), dim))
                full[:, 0] = out
                return full
            return out

        return f

    @property
    def velocity(self) -> np.ndarray:
        """H(div) velocity dof vector (normal-moment + interior coeffs)."""
        return self.u[: self.V.ndof].cpu().numpy()

    @property
    def pressure(self) -> np.ndarray:
        return -self.p.cpu().numpy()

    def AddForce(self, force):
        """Add the load of the volume force ``force`` (a callable, points
        (N, dim) -> values (N, dim)) to the right-hand side ``f``."""
        self.f = self.f + torch.as_tensor(
            self._force_local(force), device=self.device).to(self.dtype)

    def _force_local(self, force) -> np.ndarray:
        """int f . v dx over the H(div) basis, assembled on the host."""
        mesh = self.mesh
        dim = mesh.dim
        J, detJ, _ = mesh.element_jacobians
        if dim == 2:
            hb = self.V.basis
            vol = triangle_rule(2 * hb.order + 2)
            v_val, _ = hb.tabulate(vol.points)
            v_p = np.einsum("ecA,qiA->eqic", J, v_val,
                            optimize=True) / detJ[:, None, None, None]
            v_p = v_p * self.V.element_signs[:, None, :, None]
            nbv = hb.n_basis
        else:
            vol = tetrahedron_rule(2 * self.V.order + 2)
            v_val, _ = self.V.tabulate_elements(vol.points)
            v_p = np.einsum("ecA,eqiA->eqic", J, v_val,
                            optimize=True) / detJ[:, None, None, None]
            nbv = self.V.n_basis
        qpts = mesh.points[mesh.elements[:, 0]][:, None, :] + np.einsum(
            "eab,qb->eqa", J, vol.points, optimize=True)
        fq = np.asarray(force(qpts.reshape(-1, dim))).reshape(mesh.ne, -1,
                                                              dim)
        fe_v = np.einsum("q,eqc,eqic,e->ei", vol.weights, fq, v_p, detJ,
                         optimize=True)
        fe = np.zeros((mesh.ne, self.A_cond_np.shape[1]))
        fe[:, :nbv] = fe_v
        out = np.zeros(self.n)
        np.add.at(out, self.Xv.element_dofs.ravel(), fe.ravel())
        return out

    def reconstruct_stress(self, u=None) -> np.ndarray:
        """The eliminated (sigma, W) fields per element, (ne, n_el) numpy:
        (sigma, W) = -Acc^{-1} A_rc^T u_loc (homogeneous local rhs)."""
        u = self.u if u is None else u
        if isinstance(u, torch.Tensor):
            u = u.detach().cpu().numpy()
        ue = np.asarray(u)[self.Xv.element_dofs]
        rhs = -np.einsum("eic,ei->ec", self._A_rc, ue, optimize=True)
        return np.einsum("ecd,ed->ec", self._Acc_inv, rhs, optimize=True)

    @property
    def preA(self):
        return self._preA_for(GS=False)

    def _preA_for(self, GS: bool):
        """The A-preconditioner, additive (``GS=False``) or symmetric
        multicolor block-GS (``GS=True``), built once per variant in the
        model's precision.  2D: ``build_hybrid_preconditioner``
        (models/stokes_hybrid.py) with the model's ``preconditioner``;
        ``auxspace`` is the vertex stars with the vector-P1 coarse
        correction, damped for the GS sweep.  3D ``auxspace``: the
        skeleton preconditioner with the JAX model's settings -- every
        table stored in the model's dtype, coarse damping target 0.9 and
        the tables as computed (``symmetrize=False``); 3D ``faceblock``:
        the face and cell blocks of
        the hybrid space (:func:`~.stokes_hybrid3d.hybrid_blocks_3d`),
        additive or swept by :class:`~navier_stokes_tpu_torch.precond.
        multicolor.MulticolorGS` around no coarse correction."""
        if GS not in self._preA_cache:
            dt, dev = self.dtype, self.device
            if self.mesh.dim == 2:
                pre = build_hybrid_preconditioner(
                    self.Xv, self.A_cond_np, self.preconditioner,
                    self._dirich, dt, coarse_coefficient=self.nu, gs=GS,
                    A_apply=self.A if GS else None, device=dev)
            elif self.preconditioner == "auxspace":
                pre = build_skeleton_preconditioner_3d(
                    self.Xv, self.A_cond_np, self._dirich, dev, dt,
                    coarse_coefficient=self.nu, gs=GS, ext_dtype=dt,
                    inv_dtype=dt, panel_dtype=dt, sweep_dtype=dt,
                    coarse_target=0.9, symmetrize=False)
            elif GS:
                blks = free_blocks(self.Xv, "face")
                dofs, mats = extract_blocks_from_local(
                    self.A_cond_np, self.Xv.element_dofs, blks, self.n)
                colors = color_blocks(blks, self.n, self.Xv.element_dofs)
                mgs = MulticolorGS(dofs, mats, colors, self.n, dt, dev)
                pre = symmetric_gs_preconditioner(mgs, self.A, None,
                                                  self.free)
            else:
                pre = build_faceblock_preconditioner_3d(
                    self.Xv, self.A_cond_np, dt, device=dev)
            self._preA_cache[GS] = pre
        return self._preA_cache[GS]

    @traced("stokes_solve")
    def SolveInitial(self, timesteps=None, iterative: bool = True,
                     GS: bool = True, tol: float = 1e-10,
                     maxsteps: int = 100000, scale_k=None):
        """The initial Stokes solve from the boundary data, as the JAX
        model's: Bramble-Pasciak CG (v2) on the homogeneous system
        A du + B^T p = f - A u_bc, B du = -B u_bc with ``_preA_for(GS)``
        and ``preM``, to ``tol`` relative.  Sets ``u``, ``p``,
        ``stokes_bpcg_iterations``, ``stokes_bpcg_time`` (the named timer
        ``stokes-bpcg`` over the right-hand side, the Lanczos scaling and
        the iteration; the preconditioner is built before it) and
        ``stokes_bpcg_scale_k``, and returns the solver's result.
        ``scale_k``: the Bramble-Pasciak scaling, from Lanczos when None.
        ``iterative`` is the reference's flag; the solve is always BPCG, as
        in the JAX model.

        ``timesteps`` = n instead: n pseudo-time Stokes steps from the
        current state, each projected; returns None."""
        if timesteps:
            self.Project()
            for _ in range(timesteps):
                temp = torch.where(self.free, -self._A_raw_step(self.u), 0.0)
                temp2, _ = self._project_velocity(self._inv_mstar(temp))
                self.u = self.u + self.timestep * temp2
                self.Project()
            return None

        preA = self._preA_for(GS)
        timer = Timer("stokes-bpcg").Start()
        f_mod = torch.where(self.free, self.f - self.A_raw(self.u_bc), 0.0)
        g_mod = -self.B_raw(self.u_bc)
        if scale_k is None:
            scale_k, _ = bp_scale_factor(self.A, preA, f_mod)
        res = bramble_pasciak_cg_opt(
            self.A, self.B, self.BT, preA, self.preM, f_mod, g_mod, tol=tol,
            maxsteps=maxsteps, rel_err=True, scale_k=scale_k)
        timer.Stop(res.x)
        self.u = self.u_bc + res.x[0]
        self.p = res.x[1]
        self.stokes_bpcg_iterations = int(res.iterations)
        self.stokes_bpcg_time = timer.time
        self.stokes_bpcg_scale_k = float(scale_k)
        return res

    @traced("mstar_cg")
    def _inv_mstar(self, rhs, precision: float = 1e-4, maxsteps: int = 2000):
        res = cg(self.mstar, rhs, pre=self.preMstar, tol=precision,
                 maxsteps=maxsteps)
        self.last_iterations["mstar"] = res.iterations
        return res.x

    def _mass_chebyshev(self, degree: int = 16, bounds=None):
        """Fixed-degree Chebyshev approximation of Mv^{-1}; the projection
        stays exactly divergence-free for any SPD inner operator.  Built
        once: ``bounds`` (alpha, beta) replace the Lanczos estimate of the
        first call (``.bounds`` of the result carries them to another
        model)."""
        if self._mass_cheb is None:
            self._mass_cheb = self._timed(
                "mass chebyshev", lambda: chebyshev_preconditioner(
                    self._Mv, self._preMv, self.u_bc, degree=degree,
                    bounds=bounds, lower_fraction=0.02))
        return self._mass_cheb

    def _pre_proj_twolevel(self):
        """Element-block Jacobi + vertex-P1 Laplacian coarse for the
        projection Schur complement S = B Mv^{-1} B^T.

        S is spectrally a pressure POISSON operator (Neumann at walls,
        Dirichlet-like at the outflow) whose conditioning is dominated by
        the anisotropic sliver elements near the cylinder.  The block is
        the ELEMENT-LOCAL Schur B_e Mloc_e^+ B_e^T (shared velocity faces
        double-counted -- a factor-~2 spectral perturbation the CG
        tolerates), inverted on the host in f64 and applied through
        :func:`batched_local_matvec`; the coarse transfer is ONE
        reference-frame matrix (m, d+1): pressure is elementwise modal, and
        the L2 projection of a vertex-linear field onto the element basis
        has the same coefficients on every affine element."""
        if self._pre_proj2 is None:
            self._pre_proj2 = self._timed("projection twolevel",
                                          self._build_pre_proj_twolevel)
        return self._pre_proj2

    def _build_pre_proj_twolevel(self):
        dev, dtype = self.device, self.dtype
        # element-block Jacobi on S (host setup, batched tiny inverses)
        B_loc = np.asarray(self.B_loc_np, np.float64)
        M_loc = np.asarray(self._M_loc_np, np.float64)
        ne, mQ, _ = B_loc.shape
        Mpinv = np.linalg.pinv(M_loc, rcond=1e-10)
        S_blk = np.einsum("epi,eij,eqj->epq", B_loc, Mpinv, B_loc,
                          optimize=True)
        S_inv = torch.as_tensor(np.linalg.pinv(S_blk, rcond=1e-8),
                                device=dev).to(dtype).contiguous()

        def block(p):
            pe = p.reshape(ne, mQ).contiguous()
            return batched_local_matvec(S_inv, pe).reshape(-1)

        if not self.outflow:
            # enclosed flow: block + demean (the pure-Neumann coarse
            # Laplacian is singular)
            @traced("twolevel")
            def pre_enc(p):
                y = block(p - torch.mean(p))
                return y - torch.mean(y)

            pre_enc.block, pre_enc.S_inv = block, S_inv
            pre_enc.coarse_amg_levels = 0
            return pre_enc

        mesh = self.mesh
        qb = self.Q.basis
        rule = (tetrahedron_rule if mesh.dim == 3 else triangle_rule)(
            2 * max(self.Q.order, 1) + 1)
        q_val, _ = qb.tabulate(rule.points)  # (nq, m)
        lam = np.concatenate(
            [1 - rule.points.sum(1, keepdims=True), rule.points], axis=1
        )  # (nq, d+1)
        Mref = np.einsum("q,qa,qb->ab", rule.weights, q_val, q_val)
        Tref = np.linalg.solve(
            Mref, np.einsum("q,qa,qv->av", rule.weights, q_val, lam)
        )  # (m, d+1): element coefficients of a vertex-linear field
        solve1 = coarse_p1_solver(H1(mesh, 1, dirichlet=self.outflow), 1.0,
                                  dtype, device=dev)
        els = torch.as_tensor(mesh.elements.astype(np.int64), device=dev)
        Tref_t = torch.as_tensor(Tref, device=dev).to(dtype)
        to_vertices = ScatterPlan(els, mesh.nv)

        @traced("twolevel")
        def pre(p):
            pe = p.reshape(ne, mQ)
            g = to_vertices(pe @ Tref_t)
            z = solve1(g)
            coarse = (z[els] @ Tref_t.T).reshape(-1)
            return block(p) + coarse

        pre.block = block
        pre.S_inv = S_inv
        # ELL levels of the coarse solve's AMG hierarchy (0: dense inverse)
        pre.coarse_amg_levels = getattr(solve1, "levels", 0)
        return pre

    @traced("projection")
    def _project_velocity(self, u, tol: float = 1e-9, maxsteps: int = 2000):
        Minv = self._mass_chebyshev()

        def S(p):
            return self.B(Minv(self.BT(p)))

        rhs = self.B_raw(u)
        pres = cg(S, rhs, pre=self._pre_proj_twolevel(), tol=tol,
                  maxsteps=maxsteps)
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
        function of the state.  ``project_tol``: relative tolerance of the
        divergence projection CG -- the default matches DoTimeStep's f64
        semantics; an f32 stepping model must pass a reachable one (~1e-5)
        or the projection burns its full maxsteps every step.  The lazy
        setup (Chebyshev bounds, projection preconditioner, convection and
        mass tables) happens here, not in the first step."""
        self._mass_chebyshev()
        self._pre_proj_twolevel()
        self._build_convection()
        _ = self._M_loc  # ship the mass table now
        free, f, dt = self.free, self.f, self.timestep
        conv, A_raw = self.convection, self._A_raw_step
        inv_mstar, project = self._inv_mstar, self._project_velocity

        @traced("step")
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

"""Navier-Stokes on the MCS discretization in 3D — the flagship model.

Counterpart of ``navier_stokes_tpu/models/navier_stokes_mcs.py``, 3D only,
up to the operators of the initial Stokes solve: V = BDM_k H(div) velocity
on tets, tangential facet velocity of order k-1, H(curl,div) stress sigma
and the vector vorticity multiplier W, with sigma and W eliminated per
element by batched static condensation.  The condensed [H(div) | facet]
operator A, the pressure coupling B (L2 order k-1) and the pressure-mass
preconditioner preM are built here; element assembly and condensation run
once on the host in f64 numpy, the face-major operator tables live on
``device`` in f64.

With ``geometry=`` (mesh/curved.curve_to_cylinder_3d) the curved-layer
element rows are re-assembled isoparametrically, as the bench's default
order-3 curved cylinder.

Not carried over (yet): 2D, convection and time stepping.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..fem.hcurldiv3d import hcurldiv_tet
from ..fem.hdiv3d import HDiv3D
from ..fem.quadrature import tetrahedron_rule
from ..fem.reference import TET_FACES, TET_VERTICES, triangle_modal
from ..fem.spaces import L2
from ..ops.assembly import mass_diagonal
from ..ops.faceblock import FaceBlockLayout
from ..ops.facets3d import facet_geometry_3d
from .stokes_hybrid3d import (
    HybridVelocitySpace3D,
    VectorFacet3D,
    interpolate_hybrid_boundary_3d,
)

__all__ = ["NavierStokesMCS", "load_host_tables"]

_CACHE_KEYS = {"tabs3d": 5, "cond": 2, "tabs3d_curved": 5, "cond_curved": 2}


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
    exactly these tables."""
    out = {}
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
        raise ValueError(f"no assembly tables among {sorted(arrays)}")
    return out


class NavierStokesMCS:
    """3D MCS model: spaces, condensed operators and the initial-solve
    right-hand side.

    ``device``: where the operator tables live; CUDA unless the caller
    passes ``device="cpu"``.  ``geometry``: a
    :class:`~navier_stokes_tpu_torch.mesh.curved.CurvedGeometry3D` whose
    curved elements are assembled isoparametrically (None: straight).
    ``assembly_cache``: a dict (see :func:`load_host_tables`) whose
    ``tabs3d`` / ``cond`` entries (``tabs3d_curved`` / ``cond_curved`` with
    a geometry) replace host assembly and condensation; filled in when they
    are missing."""

    def __init__(self, mesh, nu: float, inflow: str, outflow: str,
                 wall: str, uin, timestep: float, order: int = 2,
                 assembly_cache: dict | None = None, device=None,
                 geometry=None):
        if mesh.dim != 3:
            raise NotImplementedError("the port carries the 3D model only")
        self.device = dev = resolve_device(device)
        self.nu, self.timestep, self.uin = nu, timestep, uin
        self.inflow, self.outflow, self.wall = inflow, outflow, wall
        self.mesh, self.order = mesh, order

        dirich = inflow + "|" + wall
        self._dirich = dirich
        self.Wspace = L2(mesh, order - 1)
        self.Q = L2(mesh, order - 1)
        self.V = HDiv3D(mesh, order, dirichlet=dirich)
        self.Vhat = VectorFacet3D(
            mesh, order - 1, dirichlet=dirich + "|" + outflow
        )
        self.Xv = HybridVelocitySpace3D(self.V, self.Vhat)
        self.sigma_basis = hcurldiv_tet(order, order_trace=order - 1)
        self.geometry = geometry
        tkey = "tabs3d" if geometry is None else "tabs3d_curved"
        if assembly_cache is not None and tkey in assembly_cache:
            A_ret, A_rc, A_cc, M_full_np, B_loc_np = assembly_cache[tkey]
        else:
            A_ret, A_rc, A_cc, M_full_np, B_loc_np = _assemble_mcs_ns_local_3d(
                mesh, self.V, self.Vhat, self.sigma_basis,
                self.Wspace.basis, self.Q.basis, nu,
            )
            if geometry is not None:
                # isoparametric overwrite of the curved-layer rows
                _assemble_mcs_ns_local_curved_3d(
                    self.V, self.Vhat, self.sigma_basis, self.Wspace.basis,
                    self.Q.basis, nu, geometry, A_ret, A_rc, A_cc, M_full_np,
                    B_loc_np)
            if assembly_cache is not None:
                assembly_cache[tkey] = (A_ret, A_rc, A_cc, M_full_np,
                                        B_loc_np)
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

        n = self.Xv.ndof
        self.n = n
        self.free_np = self.Xv.free_mask
        self.free = free = torch.as_tensor(self.free_np, device=dev)
        # scatter-free face-block applies; element tables ship face-major
        self.fb = FaceBlockLayout(self.Xv, dev)
        self._A_cond = torch.as_tensor(
            self.fb.permute_blocks(self.A_cond_np), device=dev)
        self._B_perm = torch.as_tensor(
            self.fb.permute_cols(self.B_loc_np), device=dev)
        _A_apply = self.fb.elem_apply(self._A_cond)
        _B_apply, _BT_apply = self.fb.rect_apply(self._B_perm,
                                                  self.Q.element_dofs)

        def A_raw(u):
            return _A_apply(u)

        def B_raw(u):
            return _B_apply(u)

        def BT(p):
            return torch.where(free, _BT_apply(p), 0.0)

        def A(u):
            uf = torch.where(free, u, 0.0)
            return torch.where(free, A_raw(uf), u)

        def B(u):
            return B_raw(torch.where(free, u, 0.0))

        self.A, self.A_raw = A, A_raw
        self.B, self.B_raw, self.BT = B, B_raw, BT

        self._diag_Mp = mass_diagonal(self.Q)
        diag_Mp = torch.as_tensor(self._diag_Mp, device=dev)
        if not outflow:
            raise NotImplementedError(
                "enclosed flow (pressure demeaning) is not ported yet")
        self.preM = lambda p: nu * p / diag_Mp

        self._uin_np = self._wrap_uin(uin)
        self.f = torch.zeros(n, dtype=torch.float64, device=dev)
        u_bc = interpolate_hybrid_boundary_3d(self.Xv, self._uin_np, inflow)
        self.u_bc = torch.as_tensor(u_bc, device=dev)

    def _wrap_uin(self, uin):
        def f(p):
            out = np.asarray(uin(p))
            if out.ndim == 1:
                full = np.zeros((len(p), 3))
                full[:, 0] = out
                return full
            return out

        return f

"""Frozen copy of ``navier_stokes_tpu_torch/fem/hcurldiv3d.py`` for the benchmark's
plain reference (imports nothing of the program).

H(curl,div) matrix-valued stress elements on tetrahedra for 3D MCS.

Replacement for NGSolve's HCurlDiv space on tets, consumed by the dimension-generic MCS
NavierStokes (reference templates/NavierStokesSIMPLE_iterative.py:27:
``Sigma = HCurlDiv(mesh, order=order-1, orderinner=order,
discontinuous=True)``; the 3D demo drives the same class,
reference templates/NavierStokesSIMPLE_test_3D.py:20-28).

Element: trace-free 3x3 matrix polynomials of degree <= k on the reference
tet (8 scalar components), with face dofs = moments of the two tangential
components of (sigma n) against the Dubiner basis on the face.  With the
covariant-contravariant Piola map

    sigma(x) = (1/detJ) J^{-T} sigmahat(xhat) J^T

the scaled-frame face moments are affine invariant: for a face spanned by
E_i = J ehat_i with scaled normal N = E1 x E2 = detJ J^{-T} Nhat,

    int_F (sigma N).E_i phi dS/(|N| ds dt) = int_ref (sigmahat Nhat).ehat_i phi ds dt,

since E_i^T sigma N = ehat_i^T J^T (1/detJ) J^{-T} sigmahat J^T detJ J^{-T}
Nhat = ehat_i^T sigmahat Nhat.  The reference's reduced nt-trace degree
(order=k-1 with orderinner=k) is reproduced by constraining the face
moments of Dubiner degree > order_trace to zero, exactly as in 2D — the
stress trace degree then matches the tangential facet space, which the MCS
facet-term consistency requires.

Because the MCS sigma is discontinuous (all dofs element-local, eliminated
by static condensation), no inter-element orientation bookkeeping is
needed: one canonical reference basis serves every element.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .quadrature import triangle_rule
from .reference import TET_FACES, TET_VERTICES, tet_modal, triangle_modal

# 8 trace-free component matrices: 6 off-diagonal E_ab + 2 diagonal
_TF_COMPONENTS = np.zeros((8, 3, 3))
_k = 0
for _a in range(3):
    for _b in range(3):
        if _a != _b:
            _TF_COMPONENTS[_k, _a, _b] = 1.0
            _k += 1
_TF_COMPONENTS[6, 0, 0] = 1.0
_TF_COMPONENTS[6, 2, 2] = -1.0
_TF_COMPONENTS[7, 1, 1] = 1.0
_TF_COMPONENTS[7, 2, 2] = -1.0
del _k, _a, _b


@dataclass(frozen=True)
class MatrixElementBasis3D:
    """Trace-free-matrix-valued basis on the reference tetrahedron."""

    order: int
    n_basis: int
    n_face: int  # nt-moment dofs per face
    n_cell: int
    coeffs: np.ndarray  # (nb, 8*M) in the component-modal frame
    modal_order: int
    name: str = ""

    def tabulate(self, points: np.ndarray):
        """(vals (npts, nb, 3, 3), grads (npts, nb, 3, 3, 3)); the last
        grads axis is the reference derivative direction."""
        v, g = tet_modal(points, self.modal_order)
        M = v.shape[1]
        vals_m = np.einsum("cij,pm->pcmij", _TF_COMPONENTS, v).reshape(
            len(points), 8 * M, 3, 3
        )
        grads_m = np.einsum("cij,pmd->pcmijd", _TF_COMPONENTS, g).reshape(
            len(points), 8 * M, 3, 3, 3
        )
        return (
            np.einsum("pmij,nm->pnij", vals_m, self.coeffs, optimize=True),
            np.einsum("pmijd,nm->pnijd", grads_m, self.coeffs, optimize=True),
        )


def _matrix_modal_vals(points: np.ndarray, order: int) -> np.ndarray:
    v, _ = tet_modal(points, order)
    M = v.shape[1]
    return np.einsum("cij,pm->pcmij", _TF_COMPONENTS, v).reshape(
        len(points), 8 * M, 3, 3
    )


def hcurldiv_tet(order: int, order_trace: int | None = None) -> MatrixElementBasis3D:
    """Trace-free matrix tet element with nt-trace face moments.

    ``order``: polynomial degree of the matrix field (NGSolve's orderinner).
    ``order_trace``: maximal degree of the nt-trace on faces (default =
    order); order_trace < order reproduces NGSolve's
    HCurlDiv(order=order_trace, orderinner=order): face moments above
    order_trace are constrained to zero.
    """
    k = order
    kt = order if order_trace is None else order_trace
    M = (k + 1) * (k + 2) * (k + 3) // 6
    dim = 8 * M
    nfd_scalar = (k + 1) * (k + 2) // 2  # Dubiner modes of degree <= k
    nfd_keep = (kt + 1) * (kt + 2) // 2

    q2 = triangle_rule(2 * k + 2)
    fvals, _ = triangle_modal(q2.points, k)  # orthonormal on the unit tri
    # Dubiner mode degrees (same ordering as triangle_modal)
    from .reference import triangle_modal_indices

    mode_deg = [i + j for (i, j) in triangle_modal_indices(k)]

    rows = []
    keep = []
    for lf in range(4):
        verts = [TET_VERTICES[v] for v in TET_FACES[lf]]
        origin = verts[0]
        e1 = verts[1] - verts[0]
        e2 = verts[2] - verts[0]
        nsc = np.cross(e1, e2)
        pts = (
            origin[None, :]
            + q2.points[:, 0:1] * e1[None, :]
            + q2.points[:, 1:2] * e2[None, :]
        )
        vm = _matrix_modal_vals(pts, k)  # (nq, dim, 3, 3)
        sn = np.einsum("qnij,j->qni", vm, nsc)  # (nq, dim, 3)
        for c, tang in enumerate((e1, e2)):
            snt = sn @ tang  # (nq, dim)
            for j in range(nfd_scalar):
                keep.append(mode_deg[j] <= kt)
                rows.append(
                    np.einsum("q,q,qn->n", q2.weights, fvals[:, j], snt)
                )
    L = np.stack(rows)  # (4 * 2 * nfd_scalar, dim)
    keep = np.asarray(keep)
    pattern = np.zeros((len(rows), int(keep.sum())))
    pattern[np.where(keep)[0], np.arange(keep.sum())] = 1.0
    W_face = np.linalg.pinv(L) @ pattern
    _, s, Vt = np.linalg.svd(L)
    rank = int(np.sum(s > 1e-10 * s[0]))
    null = Vt[rank:].T  # all moments zero
    coeffs = np.concatenate([W_face, null], axis=1).T
    nb = coeffs.shape[0]
    n_face = 2 * nfd_keep
    return MatrixElementBasis3D(
        order=k, n_basis=nb, n_face=n_face, n_cell=nb - 4 * n_face,
        coeffs=coeffs, modal_order=k,
        name=f"HCurlDiv{k}t{kt}-tet",
    )

"""H(curl,div) matrix-valued stress elements (2D) for the MCS method.

Replacement for NGSolve's HCurlDiv space, used by the reference's
MCS Stokes family (reference discretizations.py:81-88,
reference stokes_hcurldiv.py:18-24) and at the heart of the
NavierStokes MCS discretization
(reference templates/NavierStokesSIMPLE_iterative.py:27).

Element: trace-free 2x2 matrix polynomials of degree <= k on the reference
triangle (3 scalar components a,b,c via sigma = [[a, b], [c, -a]]),
constructed like the BDM element: per-edge dofs are moments of the
normal-tangential trace (sigma n).t against Legendre polynomials (the
quantity continuous across edges for H(curl,div)), edge basis = pinv delta
basis, interior = nullspace.

Mapping: sigma(x) = (1/detJ) J^{-T} sigmahat(xhat) J^T — chosen so that
tauhat^T (J^T sigma J^{-T}) nhat = tauhat^T sigmahat nhat, which makes the
scaled-tangent/scaled-normal edge moments affine-invariant:
int_e (sigma n).tau_scaled L_j ds = int_0^1 (sigmahat nhat_sc).tauhat_sc L_j dt.
Orientation: flipping the edge direction negates BOTH the scaled normal and
the scaled tangent, so only the Legendre parity (-1)^j remains as a sign.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..mesh.mesh import Mesh
from .hdiv import _EDGE_N_SCALED, _EDGE_TAU, edge_points, legendre_01
from .quadrature import gauss_legendre_01
from .reference import triangle_modal


@dataclass(frozen=True)
class MatrixElementBasis:
    """Trace-free-matrix-valued basis on the reference triangle."""

    order: int
    n_basis: int
    n_edge: int
    n_cell: int
    coeffs: np.ndarray  # (nb, 3*M) in the (a,b,c) modal frame
    modal_order: int
    name: str = ""

    def tabulate(self, points: np.ndarray):
        """(vals (npts, nb, 2, 2), grads (npts, nb, 2, 2, 2)); the last
        axis of grads is the reference derivative direction."""
        v, g = triangle_modal(points, self.modal_order)
        M = v.shape[1]
        npts = len(points)
        vals_m = np.zeros((npts, 3 * M, 2, 2))
        grads_m = np.zeros((npts, 3 * M, 2, 2, 2))
        # component a: [[1,0],[0,-1]], b: [[0,1],[0,0]], c: [[0,0],[1,0]]
        vals_m[:, :M, 0, 0] = v
        vals_m[:, :M, 1, 1] = -v
        vals_m[:, M:2 * M, 0, 1] = v
        vals_m[:, 2 * M:, 1, 0] = v
        grads_m[:, :M, 0, 0, :] = g
        grads_m[:, :M, 1, 1, :] = -g
        grads_m[:, M:2 * M, 0, 1, :] = g
        grads_m[:, 2 * M:, 1, 0, :] = g
        return (
            np.einsum("pmij,nm->pnij", vals_m, self.coeffs),
            np.einsum("pmijd,nm->pnijd", grads_m, self.coeffs),
        )


def hcurldiv_triangle(order: int, order_trace: int | None = None) -> MatrixElementBasis:
    """Trace-free matrix element with nt-trace edge moments.

    ``order``: polynomial degree of the matrix field (NGSolve's orderinner).
    ``order_trace``: maximal degree of the nt-trace on edges (default =
    order).  order_trace < order reproduces NGSolve's
    HCurlDiv(order=order_trace, orderinner=order)
    (NavierStokesSIMPLE_iterative.py:27): edge moments above order_trace are
    constrained to zero, so the stress trace degree matches the tangential
    facet space — required for the consistency of the MCS facet terms.
    """
    k = order
    kt = order if order_trace is None else order_trace
    M = (k + 1) * (k + 2) // 2
    dim = 3 * M
    nq = k + 2
    t, w = gauss_legendre_01(nq)

    def modal_vals(points):
        v, _ = triangle_modal(points, k)
        npts = len(points)
        vals_m = np.zeros((npts, dim, 2, 2))
        vals_m[:, :M, 0, 0] = v
        vals_m[:, :M, 1, 1] = -v
        vals_m[:, M:2 * M, 0, 1] = v
        vals_m[:, 2 * M:, 1, 0] = v
        return vals_m

    rows = []
    keep = []  # rows that become dofs (degree <= kt); others are constraints
    for e in range(3):
        pts = edge_points(e, t)
        vm = modal_vals(pts)  # (nq, dim, 2, 2)
        # (sigma nhat_scaled) . tauhat_scaled
        snt = np.einsum(
            "qnij,j,i->qn", vm, _EDGE_N_SCALED[e], _EDGE_TAU[e]
        )
        for j in range(k + 1):
            keep.append(j <= kt)
            rows.append(np.einsum("q,q,qn->n", w, legendre_01(t, j), snt))
    L = np.stack(rows)  # (3(k+1), dim)
    keep = np.asarray(keep)
    # edge basis: delta on the kept moments, ZERO on the constrained ones
    pattern = np.zeros((len(rows), int(keep.sum())))
    pattern[np.where(keep)[0], np.arange(keep.sum())] = 1.0
    W_edge = np.linalg.pinv(L) @ pattern
    _, s, Vt = np.linalg.svd(L)
    null = Vt[np.linalg.matrix_rank(L, tol=1e-10):].T  # all moments zero
    coeffs = np.concatenate([W_edge, null], axis=1).T
    nb = coeffs.shape[0]
    n_edge = kt + 1
    assert nb == dim - 3 * (k - kt)
    return MatrixElementBasis(
        order=k, n_basis=nb, n_edge=n_edge, n_cell=nb - 3 * n_edge,
        coeffs=coeffs, modal_order=k,
        name=f"HCurlDiv{k}t{kt}-tri",
    )


@dataclass
class HCurlDivSpace:
    """Global H(curl,div) space: nt-continuous edge dofs + cell dofs."""

    mesh: Mesh
    basis: MatrixElementBasis
    ndof: int
    element_dofs: np.ndarray  # (ne, nb) int32
    element_signs: np.ndarray  # (ne, nb)
    dirichlet_names: str = ""
    name: str = "HCurlDiv"

    @property
    def order(self) -> int:
        return self.basis.order

    @cached_property
    def free_mask(self) -> np.ndarray:
        return ~self.boundary_dof_mask(self.dirichlet_names)

    def boundary_dof_mask(self, names: str) -> np.ndarray:
        mask = np.zeros(self.ndof, dtype=bool)
        if not names:
            return mask
        ne_d = self.basis.n_edge
        for f in self.mesh.boundary_facet_ids(names):
            mask[f * ne_d: (f + 1) * ne_d] = True
        return mask


def HCurlDiv(mesh: Mesh, order: int, dirichlet: str = "") -> HCurlDivSpace:
    if mesh.dim != 2:
        raise NotImplementedError("H(curl,div) elements currently 2D")
    b = hcurldiv_triangle(order)
    ne_d, nc_d = b.n_edge, b.n_cell
    off_c = mesh.nedge * ne_d
    ndof = off_c + mesh.ne * nc_d
    ne = mesh.ne
    table = np.zeros((ne, b.n_basis), dtype=np.int64)
    signs = np.ones((ne, b.n_basis))
    eids = mesh.element_edges
    flip = mesh.element_edge_flip
    col = 0
    for le in range(3):
        base = eids[:, le].astype(np.int64) * ne_d
        for j in range(ne_d):
            table[:, col] = base + j
            # both normal and tangent flip: only the Legendre parity remains
            signs[:, col] = np.where(flip[:, le], (-1.0) ** j, 1.0)
            col += 1
    cells = np.arange(ne, dtype=np.int64)
    for m in range(nc_d):
        table[:, col] = off_c + cells * nc_d + m
        col += 1
    return HCurlDivSpace(
        mesh, b, ndof, table.astype(np.int32), signs, dirichlet,
        name=f"HCurlDiv{order}",
    )

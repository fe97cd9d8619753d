"""H(div)-conforming vector elements (BDM/RT) and tangential facet spaces.

Replacement for NGSolve's HDiv / VectorFacet (TangentialFacet)
spaces consumed by the reference's hybrid-DG Stokes — the *active* benchmark
configuration "HDG BDM 2" (reference run.py:277-282,
reference discretizations.py:59-78) — and the stepping stone to the
MCS discretization.

Element construction (host, float64): BDM_k = [P_k]^2 with
* per-edge dofs: moments of the normal trace against orthonormal Legendre
  polynomials on the edge (k+1 per edge),
* interior dofs: the nullspace of the normal-trace functional matrix.
The edge basis functions are the minimum-norm (pseudo-inverse) solutions
with exact delta property on the normal-trace moments, so normal continuity
across elements holds by sharing edge dofs.  Raviart-Thomas RT_k uses the
same construction on the space [P_k]^2 + x * homogeneous P_k.

Inter-element orientation: global edge dofs are defined w.r.t. the
low->high-vertex direction; an element traversing the edge backwards sees
the parameter flipped (Legendre parity factor (-1)^j) and the outward
normal negated, giving the sign s_j = -(-1)^j on flipped edges.  Signs are
folded into element-local matrices at setup so the device-side gather/
scatter machinery stays sign-free.

Mapping: contravariant Piola v(x) = J vhat(xhat)/detJ — preserves normal
traces, div v = divhat vhat / detJ, grad v = J gradhat(vhat) J^{-1} / detJ
(affine elements).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..mesh.mesh import Mesh
from .quadrature import gauss_legendre_01
from .reference import TRI_EDGES, TRI_VERTICES, jacobi_p, triangle_modal

# reference-edge geometry: tangent tau = v_b - v_a, scaled outward normal
# (tau_y, -tau_x) for the CCW unit triangle
_EDGE_TAU = np.array([[1.0, 0.0], [-1.0, 1.0], [0.0, -1.0]])
_EDGE_N_SCALED = np.array([[0.0, -1.0], [1.0, 1.0], [-1.0, 0.0]])


def legendre_01(t: np.ndarray, j: int) -> np.ndarray:
    """Orthonormal Legendre on [0,1]: int_0^1 L_i L_j dt = delta_ij."""
    return jacobi_p(2.0 * np.asarray(t) - 1.0, 0.0, 0.0, j) * np.sqrt(2.0)


def edge_points(e: int, t: np.ndarray) -> np.ndarray:
    """Points on local edge e of the unit triangle at parameters t."""
    va, vb = TRI_VERTICES[TRI_EDGES[e][0]], TRI_VERTICES[TRI_EDGES[e][1]]
    return va[None, :] + t[:, None] * (vb - va)[None, :]


@dataclass(frozen=True)
class VectorElementBasis:
    """Vector-valued basis on the reference triangle with edge/interior
    dof layout (n_edge dofs per edge, ordered by Legendre degree)."""

    order: int
    n_basis: int
    n_edge: int
    n_cell: int
    coeffs: np.ndarray  # (nb, n_modal_vec): basis in the vector-modal frame
    modal_order: int
    name: str = ""

    def tabulate(self, points: np.ndarray):
        """(vals (npts, nb, 2), grads (npts, nb, 2, 2)); grads[..., c, d] =
        d(component c)/d(xhat_d)."""
        v, g = triangle_modal(points, self.modal_order)
        M = v.shape[1]
        npts = len(points)
        # vector modal frame: first M modes are (phi, 0), next M are (0, phi)
        vals = np.zeros((npts, 2 * M, 2))
        vals[:, :M, 0] = v
        vals[:, M:, 1] = v
        grads = np.zeros((npts, 2 * M, 2, 2))
        grads[:, :M, 0, :] = g
        grads[:, M:, 1, :] = g
        return (
            np.einsum("pmc,nm->pnc", vals, self.coeffs),
            np.einsum("pmcd,nm->pncd", grads, self.coeffs),
        )


def _vector_modal_eval(points: np.ndarray, order: int) -> np.ndarray:
    v, _ = triangle_modal(points, order)
    M = v.shape[1]
    out = np.zeros((len(points), 2 * M, 2))
    out[:, :M, 0] = v
    out[:, M:, 1] = v
    return out


def bdm_triangle(order: int) -> VectorElementBasis:
    """BDM_k on the unit triangle (full [P_k]^2)."""
    if order < 1:
        raise ValueError("BDM requires order >= 1")
    k = order
    M = (k + 1) * (k + 2) // 2
    dim = 2 * M
    nq = k + 2
    t, w = gauss_legendre_01(nq)

    # normal-trace functional matrix L[(e,j), n]
    rows = []
    for e in range(3):
        pts = edge_points(e, t)
        vm = _vector_modal_eval(pts, k)  # (nq, dim, 2)
        vn = vm @ _EDGE_N_SCALED[e]  # (nq, dim)
        for j in range(k + 1):
            Lj = legendre_01(t, j)
            rows.append(np.einsum("q,q,qn->n", w, Lj, vn))
    L = np.stack(rows)  # (3(k+1), dim)

    W_edge = np.linalg.pinv(L)  # (dim, 3(k+1)): minimal-norm delta basis
    # interior: nullspace of L
    _, s, Vt = np.linalg.svd(L)
    null = Vt[np.linalg.matrix_rank(L, tol=1e-10):].T  # (dim, n_int)
    coeffs = np.concatenate([W_edge, null], axis=1).T  # (nb, dim)
    nb = coeffs.shape[0]
    assert nb == dim
    return VectorElementBasis(
        order=k, n_basis=nb, n_edge=k + 1, n_cell=nb - 3 * (k + 1),
        coeffs=coeffs, modal_order=k, name=f"BDM{k}-tri",
    )


def rt_triangle(order: int) -> VectorElementBasis:
    """RT_k on the unit triangle: [P_k]^2 + x * (homogeneous P_k).

    Represented inside [P_{k+1}]^2 via an explicit spanning set projected to
    the modal frame; dofs: k+1 normal moments per edge + interior nullspace.
    """
    k = order
    kk = k + 1  # RT_k subset of [P_{k+1}]^2
    M = (kk + 1) * (kk + 2) // 2
    dim_big = 2 * M
    # build a spanning basis of RT_k inside the degree-(k+1) vector modal
    # frame by least-squares fit at sample points
    rng = np.random.default_rng(0)
    pts = rng.random((4 * dim_big, 2))
    pts = pts[pts.sum(1) < 0.98]
    vm = _vector_modal_eval(pts, kk)  # (np, dim_big, 2)
    span_vals = []
    # [P_k]^2 part
    vk, _ = triangle_modal(pts, k)
    for m in range(vk.shape[1]):
        for c in range(2):
            col = np.zeros((len(pts), 2))
            col[:, c] = vk[:, m]
            span_vals.append(col)
    # x * homogeneous-P_k part: monomials x^i y^(k-i) times (x, y)
    for i in range(k + 1):
        mono = pts[:, 0] ** i * pts[:, 1] ** (k - i)
        span_vals.append(pts * mono[:, None])
    A = np.stack(span_vals, axis=0)  # (nspan, np, 2)
    # fit each span function in the modal frame
    vm_flat = vm.reshape(len(pts) * 2, -1)  # careful: (np,2) ordering
    vm2 = vm.transpose(0, 2, 1).reshape(-1, dim_big)
    coeff_span = []
    for f in A:
        rhs = f.reshape(-1)
        c, *_ = np.linalg.lstsq(vm2, rhs, rcond=None)
        coeff_span.append(c)
    S = np.stack(coeff_span)  # (nspan, dim_big) spanning set of RT_k
    # orthonormalize the span (rows)
    q, r = np.linalg.qr(S.T)
    rank = np.sum(np.abs(np.diag(r)) > 1e-10)
    basis_rt = q[:, :rank].T  # (nrt, dim_big)
    nrt = basis_rt.shape[0]
    assert nrt == (k + 1) * (k + 3), (nrt, (k + 1) * (k + 3))

    nq = k + 3
    t, w = gauss_legendre_01(nq)
    rows = []
    for e in range(3):
        pts_e = edge_points(e, t)
        vm_e = _vector_modal_eval(pts_e, kk)
        vn = np.einsum("qnc,c->qn", vm_e, _EDGE_N_SCALED[e])
        vn_rt = vn @ basis_rt.T  # (nq, nrt)
        for j in range(k + 1):
            Lj = legendre_01(t, j)
            rows.append(np.einsum("q,q,qn->n", w, Lj, vn_rt))
    L = np.stack(rows)  # (3(k+1), nrt) in the RT frame
    W_edge = np.linalg.pinv(L)
    _, s, Vt = np.linalg.svd(L)
    null = Vt[np.linalg.matrix_rank(L, tol=1e-10):].T
    coeffs_rt = np.concatenate([W_edge, null], axis=1).T  # (nb, nrt)
    coeffs = coeffs_rt @ basis_rt  # back to the degree-(k+1) modal frame
    nb = coeffs.shape[0]
    return VectorElementBasis(
        order=k, n_basis=nb, n_edge=k + 1, n_cell=nb - 3 * (k + 1),
        coeffs=coeffs, modal_order=kk, name=f"RT{k}-tri",
    )


def _hodivfree_reduce(b: VectorElementBasis) -> VectorElementBasis:
    """Reduce an H(div) element basis so div(V) = P0 per element (NGSolve's
    HDiv(hodivfree=True), reference discretizations.py:59-78).

    Edge functions get an interior correction cancelling the zero-mean part
    of their divergence (leaving a constant divergence); interior dofs are
    restricted to the exactly divergence-free subspace.  Edge moments are
    untouched (interior functions have zero normal trace), so the delta
    property and inter-element continuity are preserved.  Paired with P0
    pressure this yields pointwise divergence-free discrete velocities.
    """
    from .quadrature import triangle_rule

    kd = b.modal_order - 1  # div of [P_m]^2 lives in P_{m-1}
    q = triangle_rule(2 * b.modal_order)
    _, grads = b.tabulate(q.points)
    div = grads[:, :, 0, 0] + grads[:, :, 1, 1]  # (nq, nb)
    phi, _ = triangle_modal(q.points, kd)  # orthonormal, mode 0 = constant
    D = np.einsum("q,qn,qm->nm", q.weights, div, phi, optimize=True)
    ne_tot = 3 * b.n_edge
    D_edge, D_int = D[:ne_tot], D[ne_tot:]
    # interior divergences have zero mean (zero normal trace), so only the
    # zero-mean modes (columns 1:) matter for the corrections
    Dz_int, Dz_edge = D_int[:, 1:], D_edge[:, 1:]
    alpha, *_ = np.linalg.lstsq(Dz_int.T, Dz_edge.T, rcond=None)
    fit = np.abs(Dz_int.T @ alpha - Dz_edge.T).max()
    assert fit < 1e-9, fit  # interior divs must span zero-mean P_{m-1}
    coeffs_edge = b.coeffs[:ne_tot] - alpha.T @ b.coeffs[ne_tot:]
    # divergence-free interior subspace: nullspace of x -> D_int^T x
    _, s, vt = np.linalg.svd(D_int.T)
    rank = int(np.linalg.matrix_rank(D_int.T, tol=1e-10))
    coeffs_int = vt[rank:] @ b.coeffs[ne_tot:]
    coeffs = np.concatenate([coeffs_edge, coeffs_int], axis=0)
    return VectorElementBasis(
        order=b.order, n_basis=coeffs.shape[0], n_edge=b.n_edge,
        n_cell=coeffs_int.shape[0], coeffs=coeffs,
        modal_order=b.modal_order, name=b.name + "-hodivfree",
    )


@dataclass
class HDivSpace:
    """Global H(div) space: edge dofs (shared, sign-oriented) + cell dofs."""

    mesh: Mesh
    basis: VectorElementBasis
    ndof: int
    element_dofs: np.ndarray  # (ne, nb) int32
    element_signs: np.ndarray  # (ne, nb) float64 (+-1)
    dirichlet_names: str = ""
    name: str = "HDiv"

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


def HDiv(mesh: Mesh, order: int, dirichlet: str = "", RT: bool = False,
         hodivfree: bool = False) -> HDivSpace:
    """NGSolve-HDiv equivalent (discretizations.py:59-78 usage)."""
    if mesh.dim != 2:
        raise NotImplementedError("H(div) elements currently 2D")
    b = rt_triangle(order) if RT else bdm_triangle(order)
    if hodivfree:
        b = _hodivfree_reduce(b)
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
            # flipped edge: parameter reversal (-1)^j and normal negation
            table[:, col] = base + j
            signs[:, col] = np.where(flip[:, le], -((-1.0) ** j), 1.0)
            col += 1
    cells = np.arange(ne, dtype=np.int64)
    for m in range(nc_d):
        table[:, col] = off_c + cells * nc_d + m
        col += 1
    return HDivSpace(
        mesh, b, ndof, table.astype(np.int32), signs, dirichlet,
        name=f"{'RT' if RT else 'BDM'}{order}",
    )


@dataclass
class TangentialFacetSpace:
    """Tangential vector facet space: k+1 Legendre dofs per edge, direction
    = the global low->high unit tangent (NGSolve VectorFacet equivalent)."""

    mesh: Mesh
    order: int
    ndof: int
    dirichlet_names: str = ""
    name: str = "TangentialFacet"

    @property
    def n_edge(self) -> int:
        return self.order + 1

    @cached_property
    def free_mask(self) -> np.ndarray:
        return ~self.boundary_dof_mask(self.dirichlet_names)

    def boundary_dof_mask(self, names: str) -> np.ndarray:
        mask = np.zeros(self.ndof, dtype=bool)
        if not names:
            return mask
        for f in self.mesh.boundary_facet_ids(names):
            mask[f * self.n_edge: (f + 1) * self.n_edge] = True
        return mask

    @cached_property
    def edge_tangents(self) -> np.ndarray:
        """(nedge, 2) unit tangents in the global low->high direction."""
        ev = self.mesh.points[self.mesh.edges]
        tau = ev[:, 1] - ev[:, 0]
        return tau / np.linalg.norm(tau, axis=1, keepdims=True)


def VectorFacet(mesh: Mesh, order: int, dirichlet: str = "") -> TangentialFacetSpace:
    if mesh.dim != 2:
        raise NotImplementedError("facet spaces currently 2D")
    return TangentialFacetSpace(
        mesh, order, mesh.nedge * (order + 1), dirichlet
    )

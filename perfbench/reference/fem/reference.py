"""Frozen copy of ``navier_stokes_tpu_torch/fem/reference.py`` for the benchmark's
plain reference (imports nothing of the program).

Reference-element bases (host-side, numpy float64).

Replacement for NGSolve's C++ finite-element shape functions
(consumed by reference discretizations.py and reference heat.py:34,
which uses H1 order **10**).  Arbitrary-order scalar Lagrange bases on
triangles/tetrahedra are built from the orthonormal Dubiner/Koornwinder modal
basis via a Vandermonde solve; derivative tables come from the analytic
collapsed-coordinate gradient formulas, so orders up to ~10 stay accurate in
float64.

Everything here runs once at setup; the outputs are dense (n_points, n_basis)
tables frozen into device arrays for batched einsum assembly.

Reference domains: unit triangle {x,y >= 0, x+y <= 1} with vertices
v0=(0,0), v1=(1,0), v2=(0,1); unit tetrahedron analogously with v3=(0,0,1).
Local edge numbering (2D): e0=(v0,v1), e1=(v1,v2), e2=(v2,v0).
"""

from __future__ import annotations

from dataclasses import dataclass
from math import gamma as _gamma
from typing import Callable

import numpy as np

# ---------------------------------------------------------------------------
# Orthonormal Jacobi polynomials (three-term recurrence)
# ---------------------------------------------------------------------------


def jacobi_p(x: np.ndarray, alpha: float, beta: float, n: int) -> np.ndarray:
    """Orthonormal Jacobi polynomial P_n^{(alpha,beta)} on [-1,1].

    Normalized so that int_{-1}^{1} P_m P_n (1-x)^a (1+x)^b dx = delta_mn.
    """
    x = np.asarray(x, dtype=np.float64)
    gamma0 = (
        2.0 ** (alpha + beta + 1)
        / (alpha + beta + 1)
        * _gamma(alpha + 1)
        * _gamma(beta + 1)
        / _gamma(alpha + beta + 1)
    )
    p0 = np.full_like(x, 1.0 / np.sqrt(gamma0))
    if n == 0:
        return p0
    gamma1 = (alpha + 1) * (beta + 1) / (alpha + beta + 3) * gamma0
    p1 = ((alpha + beta + 2) * x / 2 + (alpha - beta) / 2) / np.sqrt(gamma1)
    if n == 1:
        return p1
    aold = 2.0 / (2 + alpha + beta) * np.sqrt(
        (alpha + 1) * (beta + 1) / (alpha + beta + 3)
    )
    pm1, p = p0, p1
    for i in range(1, n):
        h1 = 2 * i + alpha + beta
        anew = (
            2.0
            / (h1 + 2)
            * np.sqrt(
                (i + 1)
                * (i + 1 + alpha + beta)
                * (i + 1 + alpha)
                * (i + 1 + beta)
                / (h1 + 1)
                / (h1 + 3)
            )
        )
        bnew = -(alpha**2 - beta**2) / (h1 * (h1 + 2))
        pnew = (-aold * pm1 + (x - bnew) * p) / anew
        pm1, p = p, pnew
        aold = anew
    return p


def grad_jacobi_p(x: np.ndarray, alpha: float, beta: float, n: int) -> np.ndarray:
    """Derivative of the orthonormal Jacobi polynomial."""
    x = np.asarray(x, dtype=np.float64)
    if n == 0:
        return np.zeros_like(x)
    return np.sqrt(n * (n + alpha + beta + 1)) * jacobi_p(x, alpha + 1, beta + 1, n - 1)


# ---------------------------------------------------------------------------
# Dubiner modal basis on the unit triangle
# ---------------------------------------------------------------------------


def triangle_modal_count(order: int) -> int:
    return (order + 1) * (order + 2) // 2


def triangle_modal_indices(order: int) -> list[tuple[int, int]]:
    return [(i, j) for i in range(order + 1) for j in range(order + 1 - i)]


def triangle_modal(points: np.ndarray, order: int) -> tuple[np.ndarray, np.ndarray]:
    """Tabulate the orthonormal modal (Dubiner) basis on the unit triangle.

    Returns ``(vals, grads)`` with shapes (npts, nb) and (npts, nb, 2),
    orthonormal w.r.t. the unit-triangle L2 inner product.
    """
    pts = np.asarray(points, dtype=np.float64)
    x, y = pts[:, 0], pts[:, 1]
    # map to the (r,s) triangle {r,s in [-1,1], r+s<=0}, then collapse
    r = 2.0 * x - 1.0
    s = 2.0 * y - 1.0
    denom = 1.0 - s
    singular = np.abs(denom) < 1e-13
    a = np.where(singular, -1.0, 2.0 * (1.0 + r) / np.where(singular, 1.0, denom) - 1.0)
    b = s
    half1mb = 0.5 * (1.0 - b)

    idx = triangle_modal_indices(order)
    nb = len(idx)
    vals = np.zeros((len(pts), nb))
    grads = np.zeros((len(pts), nb, 2))
    for m, (i, j) in enumerate(idx):
        fa = jacobi_p(a, 0.0, 0.0, i)
        dfa = grad_jacobi_p(a, 0.0, 0.0, i)
        gb = jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
        dgb = grad_jacobi_p(b, 2.0 * i + 1.0, 0.0, j)

        norm = 2.0 ** (i + 0.5)  # Hesthaven-Warburton normalization
        hw_val = norm * fa * gb * half1mb**i

        dmodedr = dfa * gb
        if i > 0:
            dmodedr = dmodedr * half1mb ** (i - 1)
        dmodeds = dfa * (gb * (0.5 * (1.0 + a)))
        if i > 0:
            dmodeds = dmodeds * half1mb ** (i - 1)
        tmp = dgb * half1mb**i
        if i > 0:
            tmp = tmp - 0.5 * i * gb * half1mb ** (i - 1)
        dmodeds = dmodeds + fa * tmp
        hw_dr = norm * dmodedr
        hw_ds = norm * dmodeds

        # hw basis is orthonormal on the (r,s) triangle (area 2); rescale by 2
        # for orthonormality on the unit triangle (area 1/2), and chain-rule
        # d/dx = 2 d/dr.
        vals[:, m] = 2.0 * hw_val
        grads[:, m, 0] = 4.0 * hw_dr
        grads[:, m, 1] = 4.0 * hw_ds
    return vals, grads


# ---------------------------------------------------------------------------
# Koornwinder modal basis on the unit tetrahedron
# ---------------------------------------------------------------------------


def tet_modal_count(order: int) -> int:
    return (order + 1) * (order + 2) * (order + 3) // 6


def tet_modal_indices(order: int) -> list[tuple[int, int, int]]:
    return [
        (i, j, k)
        for i in range(order + 1)
        for j in range(order + 1 - i)
        for k in range(order + 1 - i - j)
    ]


def tet_modal(points: np.ndarray, order: int) -> tuple[np.ndarray, np.ndarray]:
    """Tabulate the orthonormal modal basis on the unit tetrahedron.

    Returns ``(vals, grads)`` with shapes (npts, nb) and (npts, nb, 3),
    orthonormal w.r.t. the unit-tetrahedron L2 inner product.
    """
    pts = np.asarray(points, dtype=np.float64)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r = 2.0 * x - 1.0
    s = 2.0 * y - 1.0
    t = 2.0 * z - 1.0
    # collapsed coordinates (Hesthaven-Warburton rsttoabc)
    den1 = -s - t
    sing1 = np.abs(den1) < 1e-13
    a = np.where(sing1, -1.0, 2.0 * (1.0 + r) / np.where(sing1, 1.0, den1) - 1.0)
    den2 = 1.0 - t
    sing2 = np.abs(den2) < 1e-13
    b = np.where(sing2, -1.0, 2.0 * (1.0 + s) / np.where(sing2, 1.0, den2) - 1.0)
    c = t

    idx = tet_modal_indices(order)
    nb = len(idx)
    vals = np.zeros((len(pts), nb))
    grads = np.zeros((len(pts), nb, 3))
    for m, (i, j, k) in enumerate(idx):
        fa = jacobi_p(a, 0.0, 0.0, i)
        dfa = grad_jacobi_p(a, 0.0, 0.0, i)
        gb = jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
        dgb = grad_jacobi_p(b, 2.0 * i + 1.0, 0.0, j)
        hc = jacobi_p(c, 2.0 * (i + j) + 2.0, 0.0, k)
        dhc = grad_jacobi_p(c, 2.0 * (i + j) + 2.0, 0.0, k)

        half1mb = 0.5 * (1.0 - b)
        half1mc = 0.5 * (1.0 - c)

        # value (H&W Simplex3DP): 2*sqrt(2) fa gb hc ((1-b)/2)^i ((1-c)/2)^(i+j)
        # with normalization 2^(2i+j+1.5)
        hw_val = 2.0 * np.sqrt(2.0) * fa * gb * hc * half1mb**i * half1mc ** (i + j)

        # gradients (H&W GradSimplex3DP)
        v1 = 0.5 * (1.0 + a)
        dpdr = dfa * gb * hc
        if i > 0:
            dpdr = dpdr * half1mb ** (i - 1)
        if i + j > 0:
            dpdr = dpdr * half1mc ** (i + j - 1)

        dpds = 0.5 * (1.0 + a) * dpdr
        tmp = dgb * half1mb**i
        if i > 0:
            tmp = tmp - 0.5 * i * gb * half1mb ** (i - 1)
        if i + j > 0:
            tmp = tmp * half1mc ** (i + j - 1)
        tmp = fa * tmp * hc
        dpds = dpds + tmp

        dpdt = 0.5 * (1.0 + a) * dpdr + 0.5 * (1.0 + b) * tmp
        tmp2 = dhc * half1mc ** (i + j)
        if i + j > 0:
            tmp2 = tmp2 - 0.5 * (i + j) * hc * half1mc ** (i + j - 1)
        tmp2 = fa * gb * tmp2 * half1mb**i
        dpdt = dpdt + tmp2

        norm = 2.0 ** (2 * i + j + 1.5)
        hw_val_n = hw_val / (2.0 * np.sqrt(2.0)) * norm
        hw_dr = norm * dpdr
        hw_ds = norm * dpds
        hw_dt = norm * dpdt

        # orthonormal on the (r,s,t) tet (volume 4/3); unit tet has volume 1/6
        # -> rescale values by sqrt(8) = 2*sqrt(2); chain rule d/dx = 2 d/dr.
        scale = 2.0 * np.sqrt(2.0)
        vals[:, m] = scale * hw_val_n
        grads[:, m, 0] = 2.0 * scale * hw_dr
        grads[:, m, 1] = 2.0 * scale * hw_ds
        grads[:, m, 2] = 2.0 * scale * hw_dt
    return vals, grads


# ---------------------------------------------------------------------------
# Nodal point sets (entity-ordered: vertices, edges, [faces], interior)
# ---------------------------------------------------------------------------

TRI_VERTICES = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
TRI_EDGES = [(0, 1), (1, 2), (2, 0)]
TET_VERTICES = np.array(
    [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
)
TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
TET_FACES = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]


def triangle_lagrange_nodes(order: int) -> tuple[np.ndarray, dict]:
    """Equispaced Lagrange nodes on the unit triangle, entity-ordered.

    Returns (nodes (nb,2), layout) where layout records how many dofs sit on
    each entity class and, for edges, the node ordering convention: edge-dof
    index e*(order-1)+m is the m-th interior node walking from the edge's
    first to second local vertex.
    """
    k = order
    nodes = [TRI_VERTICES[0], TRI_VERTICES[1], TRI_VERTICES[2]]
    for (va, vb) in TRI_EDGES:
        for m in range(1, k):
            t = m / k
            nodes.append((1 - t) * TRI_VERTICES[va] + t * TRI_VERTICES[vb])
    # interior nodes, lexicographic in (i, j)
    for i in range(1, k):
        for j in range(1, k - i):
            nodes.append(np.array([i / k, j / k]))
    layout = dict(n_vertex=1, n_edge=k - 1, n_face=0,
                  n_cell=max(0, (k - 1) * (k - 2) // 2))
    if k == 0:  # pragma: no cover - order-0 handled by L2 constant basis
        raise ValueError("order must be >= 1 for Lagrange nodes")
    return np.array(nodes), layout


def tet_lagrange_nodes(order: int) -> tuple[np.ndarray, dict]:
    """Equispaced Lagrange nodes on the unit tetrahedron, entity-ordered."""
    k = order
    nodes = [TET_VERTICES[i] for i in range(4)]
    for (va, vb) in TET_EDGES:
        for m in range(1, k):
            t = m / k
            nodes.append((1 - t) * TET_VERTICES[va] + t * TET_VERTICES[vb])
    # face-interior nodes: barycentric over the face's three vertices,
    # lexicographic in (m, n) with m,n >= 1, m+n <= k-1
    for (va, vb, vc) in TET_FACES:
        for m in range(1, k):
            for n in range(1, k - m):
                lam_b, lam_c = m / k, n / k
                nodes.append(
                    (1 - lam_b - lam_c) * TET_VERTICES[va]
                    + lam_b * TET_VERTICES[vb]
                    + lam_c * TET_VERTICES[vc]
                )
    # interior
    for i in range(1, k):
        for j in range(1, k - i):
            for l in range(1, k - i - j):
                nodes.append(np.array([i / k, j / k, l / k]))
    layout = dict(
        n_vertex=1,
        n_edge=k - 1,
        n_face=max(0, (k - 1) * (k - 2) // 2),
        n_cell=max(0, (k - 1) * (k - 2) * (k - 3) // 6),
    )
    return np.array(nodes), layout


# ---------------------------------------------------------------------------
# ElementBasis: the frozen per-element basis description
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ElementBasis:
    """A scalar basis on the reference simplex with an entity dof layout.

    Dof ordering: all vertex dofs (one block per vertex), then edge dofs
    (``n_edge`` consecutive per local edge, ordered along the edge direction),
    then face dofs (3D), then interior (cell) dofs.
    """

    dim: int
    order: int
    n_basis: int
    n_vertex: int
    n_edge: int
    n_face: int
    n_cell: int
    _tabulate: Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]]
    nodes: np.ndarray | None = None  # interpolation points (nb, dim)
    name: str = ""
    nodal: bool = True  # True: basis has the delta property at ``nodes``

    def tabulate(self, points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Return (vals (npts, nb), grads (npts, nb, dim)) at ``points``."""
        return self._tabulate(np.asarray(points, dtype=np.float64))


def _nodal_from_modal(nodes, modal, order, dim):
    vals_n, _ = modal(nodes, order)
    vinv = np.linalg.inv(vals_n)  # modal->nodal change of basis

    def tab(points):
        v, g = modal(points, order)
        return v @ vinv, np.einsum("pmd,mn->pnd", g, vinv)

    return tab


def lagrange_triangle(order: int) -> ElementBasis:
    """Continuous Pk Lagrange basis on the unit triangle."""
    nodes, layout = triangle_lagrange_nodes(order)
    tab = _nodal_from_modal(nodes, triangle_modal, order, 2)
    return ElementBasis(
        dim=2, order=order, n_basis=len(nodes), _tabulate=tab, nodes=nodes,
        name=f"P{order}-tri", **layout,
    )


def lagrange_tet(order: int) -> ElementBasis:
    """Continuous Pk Lagrange basis on the unit tetrahedron."""
    nodes, layout = tet_lagrange_nodes(order)
    tab = _nodal_from_modal(nodes, tet_modal, order, 3)
    return ElementBasis(
        dim=3, order=order, n_basis=len(nodes), _tabulate=tab, nodes=nodes,
        name=f"P{order}-tet", **layout,
    )


def discontinuous_simplex(order: int, dim: int) -> ElementBasis:
    """Discontinuous Pk basis (all dofs cell-local).

    Uses the orthonormal modal basis directly for order 0 (constants) and the
    Lagrange point basis otherwise (so fields remain interpolatory).
    """
    if dim == 2:
        if order == 0:
            def tab(points):
                v, g = triangle_modal(points, 0)
                return v / v[0, 0], g  # constant 1
            return ElementBasis(dim=2, order=0, n_basis=1, n_vertex=0, n_edge=0,
                                n_face=0, n_cell=1, _tabulate=tab,
                                nodes=np.array([[1 / 3, 1 / 3]]), name="P0dc-tri")
        base = lagrange_triangle(order)
    elif dim == 3:
        if order == 0:
            def tab(points):
                v, g = tet_modal(points, 0)
                return v / v[0, 0], g
            return ElementBasis(dim=3, order=0, n_basis=1, n_vertex=0, n_edge=0,
                                n_face=0, n_cell=1, _tabulate=tab,
                                nodes=np.array([[0.25, 0.25, 0.25]]), name="P0dc-tet")
        base = lagrange_tet(order)
    else:
        raise ValueError(dim)
    return ElementBasis(
        dim=dim, order=order, n_basis=base.n_basis, n_vertex=0, n_edge=0,
        n_face=0, n_cell=base.n_basis, _tabulate=base._tabulate,
        nodes=base.nodes, name=f"P{order}dc-{'tri' if dim == 2 else 'tet'}",
    )


def crouzeix_raviart_triangle() -> ElementBasis:
    """P1 nonconforming (Crouzeix-Raviart) basis: dofs at edge midpoints.

    Replaces NGSolve's FESpace('nonconforming') used by reference
    discretizations.py:14-20.  phi_e = 1 - 2*lambda_opp(e).
    """
    mids = np.array([[0.5, 0.0], [0.5, 0.5], [0.0, 0.5]])

    def tab(points):
        x, y = points[:, 0], points[:, 1]
        lam = np.stack([1.0 - x - y, x, y], axis=1)  # barycentric
        # edge e connects (v_e, v_{e+1}); opposite vertex is (e+2) % 3
        vals = np.stack([1.0 - 2.0 * lam[:, (e + 2) % 3] for e in range(3)],
                        axis=1)
        dlam = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        grads = np.stack(
            [np.broadcast_to(-2.0 * dlam[(e + 2) % 3], (len(points), 2))
             for e in range(3)],
            axis=1,
        )
        return vals, grads

    return ElementBasis(dim=2, order=1, n_basis=3, n_vertex=0, n_edge=1,
                        n_face=0, n_cell=0, _tabulate=tab, nodes=mids,
                        name="CR-tri")


def bubble_enriched_triangle(order: int) -> ElementBasis:
    """Pk Lagrange + cubic cell bubble (27*l0*l1*l2).

    Replaces NGSolve's ``SetOrder(TRIG, 3)`` enrichment used by the MINI
    (order 1) and P2+ elements, reference discretizations.py:39-56.
    """
    base = lagrange_triangle(order)

    def tab(points):
        v, g = base.tabulate(points)
        x, y = points[:, 0], points[:, 1]
        l0, l1, l2 = 1.0 - x - y, x, y
        bub = 27.0 * l0 * l1 * l2
        dbub = 27.0 * np.stack(
            [-l1 * l2 + l0 * l2, -l1 * l2 + l0 * l1], axis=1
        )
        vals = np.concatenate([v, bub[:, None]], axis=1)
        grads = np.concatenate([g, dbub[:, None, :]], axis=1)
        return vals, grads

    nodes = np.concatenate([base.nodes, np.array([[1 / 3, 1 / 3]])])
    return ElementBasis(
        dim=2, order=max(order, 3), n_basis=base.n_basis + 1,
        n_vertex=base.n_vertex, n_edge=base.n_edge, n_face=0,
        n_cell=base.n_cell + 1, _tabulate=tab, nodes=nodes,
        name=f"P{order}+bubble-tri", nodal=False,
    )

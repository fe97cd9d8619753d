"""Frozen copy of ``navier_stokes_tpu_torch/mesh/curved.py`` for the benchmark's
plain reference (imports nothing of the program).

Curved (isoparametric) geometry of the cylinder boundary, 2D and 3D.

Counterpart of ``navier_stokes_tpu/mesh/curved.py``: the geometry map of
each element is an order-g Lagrange map x(xhat) = sum_n coords[e, n]
phi_n(xhat).  Interior elements stay affine (their higher-order nodes are
the affine images); the geometry nodes of the named boundary's edges (2D,
``curve_to_circle``: onto the circle) or faces and edges (3D,
``curve_to_cylinder_3d``: onto the z-parallel cylinder) are projected
radially.  The curved MCS assembly (models/navier_stokes_mcs.py) consumes
per-quadrature-point Jacobians and Hessians of these maps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fem.reference import TET_EDGES, TET_FACES, TRI_EDGES, lagrange_tet, lagrange_triangle
from .mesh import Mesh

__all__ = ["CurvedGeometry", "curve_to_circle", "geometry_tables",
           "geometry_hessian", "CurvedGeometry3D", "curve_to_cylinder_3d",
           "geometry_tables_3d", "geometry_hessian_3d"]


@dataclass
class CurvedGeometry:
    """Order-g geometry map: coords (ne, n_geo_nodes, dim) at the reference
    Lagrange nodes of ``basis``."""

    order: int
    coords: np.ndarray

    @property
    def basis(self):
        return lagrange_triangle(self.order)


def curve_to_circle(
    mesh: Mesh,
    boundary_name: str,
    center: tuple[float, float],
    radius: float,
    order: int = 3,
) -> CurvedGeometry:
    """Build an order-``order`` geometry snapping the named boundary's edge
    nodes onto the circle (radial projection) — mesh.Curve(order) for the
    cylinder boundary."""
    if mesh.dim != 2:
        raise ValueError("curve_to_circle takes a triangle mesh; "
                         "curve_to_cylinder_3d the tet mesh")
    gb = lagrange_triangle(order)
    J, _, _ = mesh.element_jacobians
    v0 = mesh.points[mesh.elements[:, 0]]
    coords = v0[:, None, :] + np.einsum("eab,nb->ena", J, gb.nodes)

    cx, cy = center
    fids = set(mesh.boundary_facet_ids(boundary_name).tolist())
    if not fids:
        return CurvedGeometry(order, coords)

    # local edge -> node indices of that edge (vertices + interior edge nodes)
    k = order
    edge_nodes = []
    for le, (a, b) in enumerate(TRI_EDGES):
        idx = [a, b] + list(range(3 + le * (k - 1), 3 + (le + 1) * (k - 1)))
        edge_nodes.append(np.asarray(idx))

    for e in range(mesh.ne):
        for le in range(3):
            if int(mesh.element_edges[e, le]) in fids:
                idx = edge_nodes[le]
                pts = coords[e, idx]
                d = pts - np.array([cx, cy])
                r = np.linalg.norm(d, axis=1, keepdims=True)
                coords[e, idx] = np.array([cx, cy]) + radius * d / r
    return CurvedGeometry(order, coords)


@dataclass
class CurvedGeometry3D:
    """Order-g tet geometry map: coords (ne, n_geo_nodes, 3) at the
    reference Lagrange-tet nodes; ``curved_elements`` lists the elements
    whose map is non-affine (all others are exactly the affine map)."""

    order: int
    coords: np.ndarray
    curved_elements: np.ndarray

    @property
    def basis(self):
        return lagrange_tet(self.order)


def curve_to_cylinder_3d(mesh: Mesh, boundary_name: str,
                         center: tuple[float, float], radius: float,
                         order: int = 3) -> CurvedGeometry3D:
    """Order-``order`` tet geometry snapping every geometry node of the
    named boundary's faces onto the z-parallel cylinder (radial projection
    in the xy-plane, z kept).

    A node moves iff its generating entity -- a surface edge or a surface
    face -- lies on the boundary, in every element containing that entity,
    so the map stays continuous across elements.  Raises ValueError when the
    boundary has no faces: there is nothing to curve."""
    if mesh.dim != 3:
        raise ValueError("curve_to_cylinder_3d needs a tetrahedral mesh")
    gb = lagrange_tet(order)
    J, _, _ = mesh.element_jacobians
    v0 = mesh.points[mesh.elements[:, 0]]
    coords = v0[:, None, :] + np.einsum("eab,nb->ena", J, gb.nodes)

    fids = mesh.boundary_facet_ids(boundary_name)
    if not len(fids):
        raise ValueError(f"boundary {boundary_name!r} has no faces to curve")
    surf_faces = {tuple(f) for f in np.sort(mesh.faces[fids], axis=1)}
    surf_edges = set()
    for f in mesh.faces[fids]:
        a, b, c = sorted(int(x) for x in f)
        surf_edges.update({(a, b), (a, c), (b, c)})

    k = order
    nfi = max(0, (k - 1) * (k - 2) // 2)
    cxy = np.asarray(center)

    def snap(e, idx):
        d = coords[e, idx, :2] - cxy
        r = np.linalg.norm(d, axis=1, keepdims=True)
        coords[e, idx, :2] = cxy + radius * d / r

    els = mesh.elements
    curved = np.zeros(mesh.ne, dtype=bool)
    for e in range(mesh.ne):
        ev = els[e]
        for le, (va, vb) in enumerate(TET_EDGES):
            key = (int(min(ev[va], ev[vb])), int(max(ev[va], ev[vb])))
            if key in surf_edges and k > 1:
                snap(e, np.arange(4 + le * (k - 1), 4 + (le + 1) * (k - 1)))
                curved[e] = True
        for lf, fverts in enumerate(TET_FACES):
            key = tuple(sorted(int(ev[v]) for v in fverts))
            if key in surf_faces and nfi:
                base = 4 + 6 * (k - 1) + lf * nfi
                snap(e, np.arange(base, base + nfi))
                curved[e] = True
    return CurvedGeometry3D(order, coords, np.where(curved)[0])


def geometry_tables_3d(coords: np.ndarray, basis, ref_points: np.ndarray):
    """(J (nc,nq,3,3), detJ (nc,nq), Jinv (nc,nq,3,3), x (nc,nq,3)) of the
    order-g tet map with node coords ``coords`` (nc, n_geo, 3) at the given
    reference points.  Raises ValueError on a non-positive Jacobian (an
    inverted curved element)."""
    vals, grads = basis.tabulate(ref_points)  # (nq, ng), (nq, ng, 3)
    x = np.einsum("qn,enc->eqc", vals, coords)
    J = np.einsum("qnd,enc->eqcd", grads, coords)
    detJ = np.linalg.det(J)
    if np.any(detJ <= 0):
        raise ValueError(
            f"{int(np.sum(detJ <= 0))} non-positive Jacobians in curved map")
    return J, detJ, np.linalg.inv(J), x


def geometry_hessian_3d(coords: np.ndarray, basis, ref_points: np.ndarray,
                        h: float = 1e-6):
    """H (nc, nq, 3c, 3A, 3B) = d^2 x_c / dxhat_A dxhat_B of the tet map
    (central differences of the exact polynomial basis gradients)."""
    nc, nq = len(coords), len(ref_points)
    H = np.zeros((nc, nq, 3, 3, 3))
    for B in range(3):
        dp = ref_points.copy()
        dp[:, B] += h
        dm = ref_points.copy()
        dm[:, B] -= h
        _, gp = basis.tabulate(dp)
        _, gm = basis.tabulate(dm)
        dg = (gp - gm) / (2 * h)  # (nq, ng, 3A)
        H[..., B] = np.einsum("qnA,enc->eqcA", dg, coords)
    return H


def geometry_hessian(geo: CurvedGeometry, ref_points: np.ndarray,
                     h: float = 1e-6):
    """H (ne, nq, 2c, 2A, 2B) = d^2 x_c / dxhat_A dxhat_B of the
    isoparametric map (central differences of the exact basis gradients;
    the basis is polynomial so the FD error ~1e-9 is far below the
    geometric consistency error of the order-g map itself)."""
    gb = geo.basis
    H = np.zeros((len(geo.coords), len(ref_points), 2, 2, 2))
    for B in range(2):
        dp = ref_points.copy()
        dp[:, B] += h
        dm = ref_points.copy()
        dm[:, B] -= h
        _, gp = gb.tabulate(dp)
        _, gm = gb.tabulate(dm)
        dg = (gp - gm) / (2 * h)  # (nq, ng, 2A)
        H[..., B] = np.einsum("qnA,enc->eqcA", dg, geo.coords)
    return H


def geometry_tables(geo: CurvedGeometry, ref_points: np.ndarray):
    """(J (ne,nq,2,2), detJ (ne,nq), Jinv (ne,nq,2,2), x (ne,nq,2)) of the
    isoparametric map at the given reference points."""
    gb = geo.basis
    vals, grads = gb.tabulate(ref_points)  # (nq, ng), (nq, ng, 2)
    x = np.einsum("qn,enc->eqc", vals, geo.coords)
    J = np.einsum("qnd,enc->eqcd", grads, geo.coords)
    detJ = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    if np.any(detJ <= 0):
        raise ValueError(
            f"{int(np.sum(detJ <= 0))} non-positive Jacobians in curved map"
        )
    Jinv = np.empty_like(J)
    Jinv[..., 0, 0] = J[..., 1, 1] / detJ
    Jinv[..., 0, 1] = -J[..., 0, 1] / detJ
    Jinv[..., 1, 0] = -J[..., 1, 0] / detJ
    Jinv[..., 1, 1] = J[..., 0, 0] / detJ
    return J, detJ, Jinv, x

"""Frozen copy of ``navier_stokes_tpu_torch/fem/spaces.py`` for the benchmark's
plain reference (imports nothing of the program).

Function spaces: global dof numbering, element dof tables, boundary masks.

Replacement for NGSolve's FESpace machinery (SURVEY.md section 2b
row 2; consumed by reference discretizations.py:6-88 and
reference heat.py:34).  A space is a frozen host-side object whose only
products are static integer tables (element_dofs), boolean masks (free dofs),
and the reference-element basis — exactly what the jitted assembly and
matrix-free operators need.

Dof numbering for continuous spaces: vertex dofs first, then edge-interior
dofs (ordered along the global low->high vertex direction, so shared edges
agree between elements), then face dofs (3D), then cell-interior dofs.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Callable

import numpy as np

from ..mesh.mesh import Mesh
from . import reference as ref


@dataclass
class FunctionSpace:
    """A scalar finite-element space on a simplicial mesh."""

    mesh: Mesh
    basis: ref.ElementBasis
    ndof: int
    element_dofs: np.ndarray  # (ne, n_basis) int32
    dirichlet_names: str = ""
    name: str = ""

    @property
    def order(self) -> int:
        return self.basis.order

    # -- boundary dofs ------------------------------------------------------

    def boundary_dof_mask(self, names: str) -> np.ndarray:
        """Boolean (ndof,): dofs whose basis functions are supported on the
        named boundary facets (vertex + edge(+face) dofs of those facets)."""
        mask = np.zeros(self.ndof, dtype=bool)
        if not names:
            return mask
        fids = self.mesh.boundary_facet_ids(names)
        if len(fids) == 0:
            return mask
        b = self.basis
        mesh = self.mesh
        if b.n_vertex:
            vmask = np.zeros(mesh.nv, dtype=bool)
            vmask[mesh.facets[fids].ravel()] = True
            mask[: mesh.nv][vmask] = True
        if mesh.dim == 2:
            if b.n_edge:
                off = mesh.nv * b.n_vertex
                for f in fids:
                    mask[off + f * b.n_edge: off + (f + 1) * b.n_edge] = True
        else:
            if b.n_edge:
                off = mesh.nv * b.n_vertex
                # edges contained in tagged faces
                face_verts = mesh.facets[fids]
                vset = {frozenset(fv) for fv in face_verts.tolist()}
                for eid, (a, bb) in enumerate(mesh.edges.tolist()):
                    if any({a, bb} <= s for s in vset):
                        mask[off + eid * b.n_edge: off + (eid + 1) * b.n_edge] = True
            if b.n_face:
                off = mesh.nv * b.n_vertex + mesh.nedge * b.n_edge
                for f in fids:
                    mask[off + f * b.n_face: off + (f + 1) * b.n_face] = True
        return mask

    @cached_property
    def free_mask(self) -> np.ndarray:
        """True for unconstrained dofs (NGSolve FreeDofs equivalent)."""
        return ~self.boundary_dof_mask(self.dirichlet_names)

    # -- interpolation ------------------------------------------------------

    def element_node_coords(self) -> np.ndarray:
        """(ne, n_basis, dim) physical coordinates of element nodal points."""
        if self.basis.nodes is None:
            raise ValueError(f"{self.basis.name} is not interpolatory")
        J, _, _ = self.mesh.element_jacobians
        v0 = self.mesh.points[self.mesh.elements[:, 0]]
        return v0[:, None, :] + np.einsum("eab,nb->ena", J, self.basis.nodes)

    def interpolate(self, f: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        """Interpolation of f(points (n,dim)) -> (n,) onto the dof vector.

        Nodal bases use point values directly; non-nodal (e.g. bubble-
        enriched) bases solve the local interpolation Vandermonde."""
        coords = self.element_node_coords()
        vals = f(coords.reshape(-1, self.mesh.dim)).reshape(coords.shape[:2])
        if not self.basis.nodal:
            vn, _ = self.basis.tabulate(self.basis.nodes)  # (np, nb)
            vals = vals @ np.linalg.inv(vn).T
        u = np.zeros(self.ndof)
        u[self.element_dofs.ravel()] = vals.ravel()
        return u

    def interpolate_boundary(
        self, f: Callable[[np.ndarray], np.ndarray], names: str
    ) -> np.ndarray:
        """Interpolate f but keep only dofs on the named boundary
        (GridFunction.Set(definedon=...) equivalent, run.py:102-104)."""
        u = self.interpolate(f)
        return np.where(self.boundary_dof_mask(names), u, 0.0)


def _continuous_dof_table(mesh: Mesh, b: ref.ElementBasis) -> tuple[int, np.ndarray]:
    """Build the global dof count + (ne, n_basis) element dof table."""
    ne, dim = mesh.ne, mesh.dim
    nv_d, nedge_d, nface_d, ncell_d = b.n_vertex, b.n_edge, b.n_face, b.n_cell
    off_e = mesh.nv * nv_d
    n_edges = mesh.nedge
    if dim == 2:
        off_c = off_e + n_edges * nedge_d
        ndof = off_c + ne * ncell_d
    else:
        off_f = off_e + n_edges * nedge_d
        off_c = off_f + len(mesh.faces) * nface_d
        ndof = off_c + ne * ncell_d

    table = np.zeros((ne, b.n_basis), dtype=np.int64)
    col = 0
    nverts = dim + 1
    if nv_d:
        table[:, :nverts] = mesh.elements
        col = nverts
    local_edges = ref.TRI_EDGES if dim == 2 else ref.TET_EDGES
    if nedge_d:
        eids = mesh.element_edges  # (ne, nle)
        flip = mesh.element_edge_flip
        for le in range(len(local_edges)):
            base = off_e + eids[:, le].astype(np.int64) * nedge_d
            for m in range(nedge_d):
                mm = np.where(flip[:, le], nedge_d - 1 - m, m)
                table[:, col] = base + mm
                col += 1
    if dim == 3 and nface_d:
        k = b.order
        # canonical face-node indexing: for global face with sorted vertices
        # (g0<g1<g2), node (m,n) has barycentric (1-m/k-n/k, m/k, n/k) wrt
        # (g0,g1,g2); local face nodes are matched by re-expressing their
        # barycentric labels in the sorted global ordering.
        face_ids = mesh.element_faces
        for lf, (va, vb, vc) in enumerate(ref.TET_FACES):
            gl = mesh.elements[:, [va, vb, vc]]  # (ne, 3) global verts, local order
            order_perm = np.argsort(gl, axis=1)  # position of sorted verts in local
            # For local node (m, n): barycentric wrt local order is
            # (k-m-n, m, n)/k. Its weight on sorted vertex j is bary[perm[j]].
            loc_nodes = [(m, n) for m in range(1, k) for n in range(1, k - m)]
            for li, (m, n) in enumerate(loc_nodes):
                bary = np.array([k - m - n, m, n])
                w = bary[order_perm]  # (ne, 3): weights in sorted-vertex order
                mm, nn = w[:, 1], w[:, 2]
                # canonical index of (mm, nn) in the lexicographic loc_nodes list
                canon = np.zeros(len(gl), dtype=np.int64)
                lut = {mn: i for i, mn in enumerate(loc_nodes)}
                for e in range(len(gl)):
                    canon[e] = lut[(int(mm[e]), int(nn[e]))]
                table[:, col] = (
                    off_f + face_ids[:, lf].astype(np.int64) * nface_d + canon
                )
                col += 1
    if ncell_d:
        cells = np.arange(ne, dtype=np.int64)
        for m in range(ncell_d):
            table[:, col] = off_c + cells * ncell_d + m
            col += 1
    assert col == b.n_basis
    return ndof, table.astype(np.int32)


def H1(mesh: Mesh, order: int, dirichlet: str = "") -> FunctionSpace:
    """Continuous Pk Lagrange space (NGSolve H1 equivalent)."""
    b = ref.lagrange_triangle(order) if mesh.dim == 2 else ref.lagrange_tet(order)
    ndof, table = _continuous_dof_table(mesh, b)
    return FunctionSpace(mesh, b, ndof, table, dirichlet, name=f"H1_{order}")


def H1_with_bubble(mesh: Mesh, order: int, dirichlet: str = "") -> FunctionSpace:
    """Pk + cubic cell bubble (NGSolve SetOrder(TRIG,3) enrichment,
    reference discretizations.py:39-56)."""
    if mesh.dim != 2:
        raise NotImplementedError("bubble enrichment only in 2D")
    b = ref.bubble_enriched_triangle(order)
    ndof, table = _continuous_dof_table(mesh, b)
    return FunctionSpace(mesh, b, ndof, table, dirichlet, name=f"H1_{order}+b")


def L2(mesh: Mesh, order: int) -> FunctionSpace:
    """Discontinuous Pk space (cell-local dofs)."""
    b = ref.discontinuous_simplex(order, mesh.dim)
    ndof, table = _continuous_dof_table(mesh, b)
    return FunctionSpace(mesh, b, ndof, table, "", name=f"L2_{order}")


def Nonconforming(mesh: Mesh, dirichlet: str = "") -> FunctionSpace:
    """Crouzeix-Raviart P1 nonconforming space
    (NGSolve FESpace('nonconforming'), reference discretizations.py:14-20)."""
    if mesh.dim != 2:
        raise NotImplementedError("Crouzeix-Raviart only in 2D")
    b = ref.crouzeix_raviart_triangle()
    ndof, table = _continuous_dof_table(mesh, b)
    return FunctionSpace(mesh, b, ndof, table, dirichlet, name="CR")


@dataclass
class VectorSpace:
    """ncomp stacked copies of a scalar space, component-major dof layout:
    dof (c, i) -> c * scalar.ndof + i  (matches the reference's
    FESpace([V, V]) component layout, run.py:99-104)."""

    scalar: FunctionSpace
    ncomp: int

    @property
    def mesh(self) -> Mesh:
        return self.scalar.mesh

    @property
    def ndof(self) -> int:
        return self.ncomp * self.scalar.ndof

    @property
    def order(self) -> int:
        return self.scalar.order

    @cached_property
    def free_mask(self) -> np.ndarray:
        return np.tile(self.scalar.free_mask, self.ncomp)

    def boundary_dof_mask(self, names: str) -> np.ndarray:
        return np.tile(self.scalar.boundary_dof_mask(names), self.ncomp)

    def interpolate(self, f: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        """f maps points (n,dim) -> (n, ncomp); returns stacked dof vector."""
        comps = []
        for c in range(self.ncomp):
            comps.append(self.scalar.interpolate(lambda p, c=c: f(p)[:, c]))
        return np.concatenate(comps)

    def interpolate_boundary(self, f, names: str) -> np.ndarray:
        mask = self.scalar.boundary_dof_mask(names)
        comps = []
        for c in range(self.ncomp):
            u = self.scalar.interpolate(lambda p, c=c: f(p)[:, c])
            comps.append(np.where(mask, u, 0.0))
        return np.concatenate(comps)


def VectorH1(mesh: Mesh, order: int, dirichlet: str = "") -> VectorSpace:
    return VectorSpace(H1(mesh, order, dirichlet), mesh.dim)

"""Frozen copy of ``navier_stokes_tpu_torch/mesh/mesh.py`` for the benchmark's
plain reference (imports nothing of the program).

Unstructured simplicial mesh with named boundaries (host-side numpy).

Replacement for the Netgen mesh objects the reference consumes
(reference run.py:22-29, reference heat.py:31).  A mesh is a frozen
set of static integer/float tables: points, elements, edge/face/facet
connectivity, and boundary-name tags.  Everything downstream (dof maps, basis
tables, assembly) is derived from these tables once at setup and shipped to
the device as fixed-shape arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np


@dataclass
class Mesh:
    """Simplicial mesh: triangles (dim=2) or tetrahedra (dim=3).

    ``boundary_tags`` maps a boundary name (e.g. "inlet") to an array of
    *facet* indices (edges in 2D, triangular faces in 3D).
    """

    points: np.ndarray  # (nv, dim) float64
    elements: np.ndarray  # (ne, dim+1) int32, vertex ids
    boundary_tags: dict[str, np.ndarray] = field(default_factory=dict)

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float64)
        self.elements = np.asarray(self.elements, dtype=np.int32)

    # -- basic counts (CSV schema of reference run.py:252-257) --------

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def nv(self) -> int:
        return len(self.points)

    @property
    def ne(self) -> int:
        return len(self.elements)

    @property
    def nedge(self) -> int:
        return len(self.edges)

    @property
    def nface(self) -> int:
        return self.ne if self.dim == 2 else len(self.faces)

    @property
    def nfacet(self) -> int:
        return len(self.facets)

    # -- derived connectivity ----------------------------------------------

    @cached_property
    def edges(self) -> np.ndarray:
        """(nedges, 2) int32, each row sorted ascending."""
        return self._edge_data[0]

    @cached_property
    def element_edges(self) -> np.ndarray:
        """(ne, n_local_edges) int32 edge ids per element."""
        return self._edge_data[1]

    @cached_property
    def element_edge_flip(self) -> np.ndarray:
        """(ne, n_local_edges) bool: local edge direction opposes global.

        Global edge direction runs from the lower to the higher vertex id;
        a flipped local edge must reverse its edge-interior dof ordering.
        """
        return self._edge_data[2]

    @cached_property
    def _edge_data(self):
        from ..fem.reference import TRI_EDGES, TET_EDGES

        local = TRI_EDGES if self.dim == 2 else TET_EDGES
        pairs = []
        for (a, b) in local:
            pairs.append(self.elements[:, [a, b]])
        raw = np.stack(pairs, axis=1)  # (ne, nle, 2)
        flip = raw[:, :, 0] > raw[:, :, 1]
        key = np.sort(raw.reshape(-1, 2), axis=1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        return (
            uniq.astype(np.int32),
            inv.reshape(self.ne, len(local)).astype(np.int32),
            flip,
        )

    @cached_property
    def faces(self) -> np.ndarray:
        """3D only: (nfaces, 3) int32, each row sorted ascending."""
        assert self.dim == 3
        return self._face_data[0]

    @cached_property
    def element_faces(self) -> np.ndarray:
        assert self.dim == 3
        return self._face_data[1]

    @cached_property
    def _face_data(self):
        from ..fem.reference import TET_FACES

        tris = []
        for (a, b, c) in TET_FACES:
            tris.append(self.elements[:, [a, b, c]])
        raw = np.stack(tris, axis=1)  # (ne, 4, 3)
        key = np.sort(raw.reshape(-1, 3), axis=1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        return uniq.astype(np.int32), inv.reshape(self.ne, 4).astype(np.int32)

    @cached_property
    def facets(self) -> np.ndarray:
        """Codim-1 entities: edges (2D) / faces (3D), rows sorted ascending."""
        return self.edges if self.dim == 2 else self.faces

    @cached_property
    def element_facets(self) -> np.ndarray:
        return self.element_edges if self.dim == 2 else self.element_faces

    @cached_property
    def facet_elements(self) -> np.ndarray:
        """(nfacet, 2) int32: adjacent elements, -1 in col 1 for boundary."""
        fe = np.full((self.nfacet, 2), -1, dtype=np.int32)
        for e in range(self.ne):
            for f in self.element_facets[e]:
                if fe[f, 0] == -1:
                    fe[f, 0] = e
                else:
                    fe[f, 1] = e
        return fe

    @cached_property
    def boundary_facets(self) -> np.ndarray:
        return np.where(self.facet_elements[:, 1] == -1)[0].astype(np.int32)

    # -- boundary-name machinery -------------------------------------------

    def boundary_facet_ids(self, names: str) -> np.ndarray:
        """Facet ids for an NGSolve-style '|'-joined boundary-name pattern."""
        ids: list[np.ndarray] = []
        for name in names.split("|"):
            name = name.strip()
            if not name:
                continue
            if name not in self.boundary_tags:
                raise KeyError(
                    f"unknown boundary '{name}'; have {sorted(self.boundary_tags)}"
                )
            ids.append(self.boundary_tags[name])
        if not ids:
            return np.empty(0, dtype=np.int32)
        return np.unique(np.concatenate(ids)).astype(np.int32)

    def boundary_vertex_mask(self, names: str) -> np.ndarray:
        mask = np.zeros(self.nv, dtype=bool)
        fids = self.boundary_facet_ids(names)
        mask[self.facets[fids].ravel()] = True
        return mask

    def tag_boundary_by_predicate(self, name: str, predicate) -> None:
        """Tag boundary facets whose vertex coordinates all satisfy predicate."""
        bf = self.boundary_facets
        pts = self.points[self.facets[bf]]  # (nbf, dim, dim)
        sel = np.all(predicate(pts), axis=1)
        self.boundary_tags[name] = bf[sel].astype(np.int32)

    # -- element geometry ---------------------------------------------------

    @cached_property
    def element_jacobians(self):
        """(J (ne,d,d), detJ (ne,), Jinv (ne,d,d)) for affine elements.

        J columns are edge vectors v_i - v_0; x = v0 + J @ x_ref.
        """
        verts = self.points[self.elements]  # (ne, d+1, d)
        J = np.stack([verts[:, i + 1] - verts[:, 0] for i in range(self.dim)], axis=2)
        detJ = np.linalg.det(J)
        if np.any(detJ <= 0):
            raise ValueError(
                f"{int(np.sum(detJ <= 0))} inverted/degenerate elements"
            )
        Jinv = np.linalg.inv(J)
        return J, detJ, Jinv

    @cached_property
    def min_max_h(self) -> tuple[float, float]:
        verts = self.points[self.elements]
        hs = []
        n = self.dim + 1
        for i in range(n):
            for j in range(i + 1, n):
                hs.append(np.linalg.norm(verts[:, i] - verts[:, j], axis=1))
        hs = np.stack(hs)
        return float(hs.min()), float(hs.max())

    def ensure_positive_orientation(self) -> None:
        """Flip elements with negative Jacobian determinant (in place)."""
        verts = self.points[self.elements]
        J = np.stack([verts[:, i + 1] - verts[:, 0] for i in range(self.dim)], axis=2)
        neg = np.linalg.det(J) < 0
        if np.any(neg):
            els = self.elements.copy()
            els[neg, -1], els[neg, -2] = (
                self.elements[neg, -2],
                self.elements[neg, -1],
            )
            self.elements = els
        for attr in ("_edge_data", "_face_data", "element_jacobians",
                     "facet_elements", "boundary_facets"):
            self.__dict__.pop(attr, None)

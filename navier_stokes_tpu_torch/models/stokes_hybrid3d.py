"""Host-side parts of the 3D hybrid [BDM | tangential facet] velocity space.

The port's own copy of the pieces of
``navier_stokes_tpu/models/stokes_hybrid3d.py`` that the MCS model uses:
the tangential facet space in each face's global frame, the hybrid velocity
space, the Dirichlet boundary interpolation (pure numpy), and the smoother
blocks with the additive face-block preconditioner of the 3D model.

Facet space: per global face, 2 * nfd dofs — coefficients of
phi_j(s,t) * E_c where phi is the orthonormal Dubiner basis in the face's
sorted-global parametrization and (E_1, E_2) the physical global tangent
frame.  Both neighboring tets evaluate these identically, so no orientation
algebra is needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..device import resolve_device
from ..fem.hdiv3d import HDivSpace3D
from ..fem.quadrature import triangle_rule
from ..fem.reference import triangle_modal
from ..precond.jacobi import block_jacobi, extract_blocks_from_local


@dataclass
class TangentialFacetSpace3D:
    mesh: object
    order: int
    ndof: int
    dirichlet_names: str = ""

    @property
    def n_scalar(self) -> int:  # scalar modes per face
        return (self.order + 1) * (self.order + 2) // 2

    @property
    def n_face(self) -> int:  # dofs per face (2 frame components)
        return 2 * self.n_scalar

    @cached_property
    def free_mask(self) -> np.ndarray:
        return ~self.boundary_dof_mask(self.dirichlet_names)

    def boundary_dof_mask(self, names: str) -> np.ndarray:
        mask = np.zeros(self.ndof, dtype=bool)
        if not names:
            return mask
        nfd = self.n_face
        for f in self.mesh.boundary_facet_ids(names):
            mask[f * nfd: (f + 1) * nfd] = True
        return mask


def VectorFacet3D(mesh, order: int, dirichlet: str = "") -> TangentialFacetSpace3D:
    nfd = 2 * (order + 1) * (order + 2) // 2
    return TangentialFacetSpace3D(mesh, order, mesh.nface * nfd, dirichlet)


@dataclass
class HybridVelocitySpace3D:
    hdiv: HDivSpace3D
    facet: TangentialFacetSpace3D

    @property
    def mesh(self):
        return self.hdiv.mesh

    @property
    def ndof(self) -> int:
        return self.hdiv.ndof + self.facet.ndof

    @property
    def order(self) -> int:
        return self.hdiv.order

    @cached_property
    def free_mask(self) -> np.ndarray:
        return np.concatenate([self.hdiv.free_mask, self.facet.free_mask])

    @cached_property
    def element_dofs(self) -> np.ndarray:
        mesh = self.mesh
        nfd = self.facet.n_face
        fac = np.zeros((mesh.ne, 4 * nfd), dtype=np.int32)
        for lf in range(4):
            base = self.hdiv.ndof + mesh.element_faces[:, lf] * nfd
            for j in range(nfd):
                fac[:, lf * nfd + j] = base + j
        return np.concatenate([self.hdiv.element_dofs, fac], axis=1)



def interpolate_hybrid_boundary_3d(
    V: HybridVelocitySpace3D, uin, names: str
) -> np.ndarray:
    """Normal moments + tangential frame moments of ``uin`` on the named
    boundary faces (global-frame functionals; see fem/hdiv3d docstring)."""
    mesh = V.mesh
    nfd_v = V.hdiv.n_face_dofs
    nss = V.facet.n_scalar
    nfd_f = V.facet.n_face

    rule = triangle_rule(2 * V.hdiv.order + 2)
    # separate tabulations per order: triangle_modal orders modes as
    # [(0,0),(0,1),(0,2),...], so the first nss columns of a HIGHER-order
    # tabulation are NOT the facet space's modes when the orders differ
    fvals, _ = triangle_modal(rule.points, V.hdiv.order)
    fvals_f, _ = triangle_modal(rule.points, V.facet.order)
    u = np.zeros(V.ndof)
    pts = mesh.points
    for f in mesh.boundary_facet_ids(names):
        gv = pts[mesh.faces[f]]  # sorted global vertices
        E1, E2 = gv[1] - gv[0], gv[2] - gv[0]
        nsc = np.cross(E1, E2)  # scaled normal (the Piola moment normal)
        xq = (
            gv[0][None, :]
            + rule.points[:, 0:1] * E1[None, :]
            + rule.points[:, 1:2] * E2[None, :]
        )
        uq = uin(xq)
        for j in range(nfd_v):
            u[f * nfd_v + j] = np.einsum(
                "q,qc,c,q->", rule.weights, uq, nsc, fvals[:, j]
            , optimize=True)
        # facet frame coefficients via the 2x2 frame Gram
        G = np.array([[E1 @ E1, E1 @ E2], [E2 @ E1, E2 @ E2]])
        Ginv = np.linalg.inv(G)
        tang = uq - (uq @ (nsc / np.linalg.norm(nsc)))[:, None] * (
            nsc / np.linalg.norm(nsc)
        )[None, :]
        for j in range(nss):
            m = np.array([
                np.einsum("q,qc,c,q->", rule.weights, tang, E1, fvals_f[:, j], optimize=True),
                np.einsum("q,qc,c,q->", rule.weights, tang, E2, fvals_f[:, j], optimize=True),
            ])
            c = Ginv @ m
            u[V.hdiv.ndof + f * nfd_f + 2 * j] = c[0]
            u[V.hdiv.ndof + f * nfd_f + 2 * j + 1] = c[1]
    return u


def hybrid_blocks_3d(V: HybridVelocitySpace3D, kind: str) -> list:
    """Smoother block index sets for a 3D [H(div) | facet] space.

    ``face``: disjoint per-face blocks (hdiv + facet dofs) and per-cell
    interior blocks.  ``vertexstar``: overlapping vertex patches -- all
    face/facet dofs of the faces containing the vertex and the interior
    dofs of the incident tets."""
    mesh = V.mesh
    nfd_v, nfd_f = V.hdiv.n_face_dofs, V.facet.n_face
    nc_d = V.hdiv.bases[0].n_cell
    off_c = mesh.nface * nfd_v
    if kind == "face":
        blocks = []
        for f in range(mesh.nface):
            blocks.append(
                list(range(f * nfd_v, (f + 1) * nfd_v))
                + list(range(V.hdiv.ndof + f * nfd_f,
                             V.hdiv.ndof + (f + 1) * nfd_f)))
        for e in range(mesh.ne):
            blocks.append(list(range(off_c + e * nc_d,
                                     off_c + (e + 1) * nc_d)))
        return blocks
    if kind != "vertexstar":
        raise ValueError(f"unknown block kind {kind!r}")
    vblocks: list[list[int]] = [[] for _ in range(mesh.nv)]
    for f, verts in enumerate(mesh.faces.tolist()):
        dofs_f = (list(range(f * nfd_v, (f + 1) * nfd_v))
                  + list(range(V.hdiv.ndof + f * nfd_f,
                               V.hdiv.ndof + (f + 1) * nfd_f)))
        for v in verts:
            vblocks[v].extend(dofs_f)
    for e, verts in enumerate(mesh.elements.tolist()):
        dofs_e = list(range(off_c + e * nc_d, off_c + (e + 1) * nc_d))
        for v in verts:
            vblocks[v].extend(dofs_e)
    return vblocks


def free_blocks(V: HybridVelocitySpace3D, kind: str) -> list[np.ndarray]:
    """The free dofs of each :func:`hybrid_blocks_3d` block; empty blocks
    dropped."""
    fmask = V.free_mask
    blks = [np.asarray([d for d in blk if fmask[d]], np.int32)
            for blk in hybrid_blocks_3d(V, kind)]
    return [b for b in blks if len(b)]


def build_faceblock_preconditioner_3d(V: HybridVelocitySpace3D,
                                      A_np: np.ndarray, dtype=torch.float64,
                                      blocks: str = "face", device=None):
    """Additive block smoother over the free dofs of the
    :func:`hybrid_blocks_3d` patches: batched dense inverses of the
    assembled operator's blocks (precond/jacobi.block_jacobi);
    ``preA.table`` is their stored inverses."""
    device = resolve_device(device)
    nV = V.ndof
    dofs, mats = extract_blocks_from_local(A_np, V.element_dofs,
                                           free_blocks(V, blocks), nV)
    smooth = block_jacobi(dofs, mats, nV, dtype, device)
    free = torch.as_tensor(V.free_mask, device=device)

    def preA(u):
        uf = torch.where(free, u, 0.0)
        return torch.where(free, smooth(uf), u)

    preA.table = smooth.table
    return preA

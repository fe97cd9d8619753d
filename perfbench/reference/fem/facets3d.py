"""Frozen copy of ``navier_stokes_tpu_torch/ops/facets3d.py`` for the benchmark's
plain reference (imports nothing of the program).

Facet (element-boundary) geometry for tetrahedral meshes.

3D counterpart of ops/facets.py: per (element, local face) tables for
DG/HDG boundary integrals, using each face's GLOBAL sorted-vertex frame —
x(s,t) = X_g0 + s (X_g1 - X_g0) + t (X_g2 - X_g0) — so quadrature points,
facet-space basis evaluations and moments agree exactly between the two
tets sharing a face.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .quadrature import triangle_rule
from .reference import TET_FACES
from ..mesh.mesh import Mesh


@dataclass(frozen=True)
class FacetGeometry3D:
    """Per (element, local_face) geometry in the global face frames."""

    qp: np.ndarray  # (nq2, 2) 2D quadrature points (s, t)
    qw: np.ndarray  # (nq2,)
    ref_points: np.ndarray  # (ne, 4, nq2, 3) element-reference coords
    normal: np.ndarray  # (ne, 4, 3) unit outward physical normal
    area: np.ndarray  # (ne, 4) physical face area (ds dt measure factor)
    frame: np.ndarray  # (ne, 4, 2, 3) physical global tangent frame (e1, e2)
    face_perm: np.ndarray  # (ne, 4, 3) local order of sorted-global vertices


def facet_geometry_3d(mesh: Mesh, degree: int) -> FacetGeometry3D:
    assert mesh.dim == 3
    rule = triangle_rule(degree)
    qp, qw = rule.points, rule.weights
    nq = len(qp)
    ne = mesh.ne
    els = mesh.elements
    pts = mesh.points
    from .reference import TET_VERTICES

    ref_points = np.zeros((ne, 4, nq, 3))
    normal = np.zeros((ne, 4, 3))
    area = np.zeros((ne, 4))
    frame = np.zeros((ne, 4, 2, 3))
    face_perm = np.zeros((ne, 4, 3), dtype=np.int32)

    # element centroids for outward orientation
    cent = pts[els].mean(axis=1)

    for lf, fverts in enumerate(TET_FACES):
        gl = els[:, list(fverts)]  # (ne, 3) global vertex ids, local order
        perm = np.argsort(gl, axis=1)  # sorted-global order positions
        face_perm[:, lf, :] = perm
        # reference-coordinate face frame, permuted per element: (ne, 3, 3)
        lv = TET_VERTICES[np.asarray(fverts)][perm]
        e1r = lv[:, 1] - lv[:, 0]
        e2r = lv[:, 2] - lv[:, 0]
        ref_points[:, lf] = (
            lv[:, None, 0, :]
            + qp[None, :, 0, None] * e1r[:, None, :]
            + qp[None, :, 1, None] * e2r[:, None, :]
        )
        # physical coords in sorted-global order: (ne, 3, 3)
        gv = pts[np.take_along_axis(gl, perm, axis=1)]
        E1 = gv[:, 1] - gv[:, 0]
        E2 = gv[:, 2] - gv[:, 0]
        cr = np.cross(E1, E2)
        a = np.linalg.norm(cr, axis=1)
        n = cr / a[:, None]
        # orient outward
        flip = np.einsum("ec,ec->e", n, gv[:, 0] - cent) < 0
        n = np.where(flip[:, None], -n, n)
        normal[:, lf] = n
        area[:, lf] = a  # |E1 x E2| = dS/(ds dt)
        frame[:, lf, 0] = E1
        frame[:, lf, 1] = E2
    return FacetGeometry3D(
        qp=qp, qw=qw, ref_points=ref_points, normal=normal, area=area,
        frame=frame, face_perm=face_perm,
    )

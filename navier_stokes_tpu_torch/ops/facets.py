"""Facet (element-boundary) geometry and trace tables for DG/HDG forms.

The machinery behind NGSolve's ``dx(element_boundary=True)`` integrals
(SURVEY.md section 2b row 3; used by the reference's HDG Stokes at
reference run.py:132-139 and the MCS forms).  All tables are host
numpy, computed once: per (element, local edge) physical normals, edge
lengths, and quadrature parameters, plus the Legendre parity factors that
reconcile local edge traversal with the global low->high orientation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fem.quadrature import gauss_legendre_01
from ..fem.reference import TRI_EDGES, TRI_VERTICES
from ..mesh.mesh import Mesh


@dataclass(frozen=True)
class FacetGeometry:
    """Per (element, local_edge) geometry for boundary integrals (2D)."""

    t: np.ndarray  # (nq1,) 1D quadrature parameters on [0,1]
    w: np.ndarray  # (nq1,) weights
    ref_points: np.ndarray  # (3, nq1, 2) local-edge quad points on ref tri
    normal: np.ndarray  # (ne, 3, 2) unit outward physical normals
    elen: np.ndarray  # (ne, 3) physical edge lengths
    tau_global: np.ndarray  # (ne, 3, 2) unit tangent of the GLOBAL edge dir
    flip: np.ndarray  # (ne, 3) bool: local traversal opposes global
    t_global: np.ndarray  # (ne, 3, nq1) global edge parameter at quad pts


def facet_geometry(mesh: Mesh, nq1: int) -> FacetGeometry:
    assert mesh.dim == 2
    t, w = gauss_legendre_01(nq1)
    ref_points = np.stack(
        [
            TRI_VERTICES[a][None, :]
            + t[:, None] * (TRI_VERTICES[b] - TRI_VERTICES[a])[None, :]
            for (a, b) in TRI_EDGES
        ]
    )  # (3, nq1, 2)

    pts = mesh.points
    els = mesh.elements
    ne = mesh.ne
    normal = np.zeros((ne, 3, 2))
    elen = np.zeros((ne, 3))
    tau_global = np.zeros((ne, 3, 2))
    flip = mesh.element_edge_flip
    for le, (a, b) in enumerate(TRI_EDGES):
        pa, pb = pts[els[:, a]], pts[els[:, b]]
        tau = pb - pa  # local traversal direction
        ln = np.linalg.norm(tau, axis=1)
        elen[:, le] = ln
        # outward normal for CCW elements: rotate traversal dir by -90
        normal[:, le, 0] = tau[:, 1] / ln
        normal[:, le, 1] = -tau[:, 0] / ln
        tg = np.where(flip[:, le, None], -tau, tau)
        tau_global[:, le] = tg / ln[:, None]
    t_global = np.where(
        flip[:, :, None], 1.0 - t[None, None, :], t[None, None, :]
    )
    return FacetGeometry(
        t=t, w=w, ref_points=ref_points, normal=normal, elen=elen,
        tau_global=tau_global, flip=flip, t_global=t_global,
    )

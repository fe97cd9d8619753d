"""Frozen copy of ``navier_stokes_tpu_torch/fem/quadrature.py`` for the benchmark's
plain reference (imports nothing of the program).

Quadrature rules on reference simplices (host-side, numpy float64).

Replaces the quadrature machinery hidden inside NGSolve's C++ integrators
(consumed by e.g. reference run.py:77-97 via SymbolicBFI).  Rules are
generated once on the host and frozen into the basis tables shipped to device.

Triangle/tet rules use the collapsed (Duffy) tensor-product construction:
exact for any requested polynomial degree, arbitrary order, and trivially
correct — the right trade-off for setup-time host code.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class QuadratureRule:
    """Points (n, dim) and weights (n,) on the reference simplex.

    Reference domains: interval [0,1]; unit triangle {x,y>=0, x+y<=1};
    unit tetrahedron {x,y,z>=0, x+y+z<=1}.
    """

    points: np.ndarray
    weights: np.ndarray
    degree: int  # exact for polynomials up to this total degree

    @property
    def dim(self) -> int:
        return self.points.shape[1]


def gauss_legendre_01(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0,1] (exact to degree 2n-1)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def interval_rule(degree: int) -> QuadratureRule:
    n = max(1, (degree + 2) // 2)
    x, w = gauss_legendre_01(n)
    return QuadratureRule(x[:, None], w, 2 * n - 1)


def triangle_rule(degree: int) -> QuadratureRule:
    """Collapsed rule on the unit triangle, exact up to ``degree``.

    Duffy map (xi, eta) -> (xi*(1-eta), eta) with Jacobian (1-eta); a degree-d
    integrand becomes degree d+1 in eta, so n = ceil((d+2)/2) GL points per
    direction suffice.
    """
    n = max(1, (degree + 3) // 2)
    x1, w1 = gauss_legendre_01(n)
    xi, eta = np.meshgrid(x1, x1, indexing="ij")
    wx, we = np.meshgrid(w1, w1, indexing="ij")
    pts = np.stack([(xi * (1.0 - eta)).ravel(), eta.ravel()], axis=1)
    wts = (wx * we * (1.0 - eta)).ravel()
    return QuadratureRule(pts, wts, degree)


def tetrahedron_rule(degree: int) -> QuadratureRule:
    """Collapsed rule on the unit tetrahedron, exact up to ``degree``.

    Duffy map (a,b,c) -> (a(1-b)(1-c), b(1-c), c), Jacobian (1-b)(1-c)^2.
    """
    n = max(1, (degree + 4) // 2)
    x1, w1 = gauss_legendre_01(n)
    a, b, c = np.meshgrid(x1, x1, x1, indexing="ij")
    wa, wb, wc = np.meshgrid(w1, w1, w1, indexing="ij")
    x = a * (1.0 - b) * (1.0 - c)
    y = b * (1.0 - c)
    z = c
    pts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    wts = (wa * wb * wc * (1.0 - b) * (1.0 - c) ** 2).ravel()
    return QuadratureRule(pts, wts, degree)


def simplex_rule(dim: int, degree: int) -> QuadratureRule:
    if dim == 1:
        return interval_rule(degree)
    if dim == 2:
        return triangle_rule(degree)
    if dim == 3:
        return tetrahedron_rule(degree)
    raise ValueError(f"unsupported dim {dim}")

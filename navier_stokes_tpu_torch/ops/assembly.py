"""Host-side assembly helpers of the straight 3D path (numpy / scipy).

The parts of ``navier_stokes_tpu/ops/assembly.py`` that the flagship setup
uses: global CSR assembly of element matrices (the P1 coarse stiffness,
precond/twolevel.py), the P1 stiffness element tables, and the pressure
mass diagonal behind ``preM`` (models/navier_stokes_mcs.py).
"""

from __future__ import annotations

import numpy as np

from ..fem.quadrature import simplex_rule
from ..fem.spaces import FunctionSpace


def assemble_csr(a_local, eldofs, ndof: int, ndof_col: int | None = None):
    """scipy CSR from element matrices (ne, nr, nc) and dofs (ne, nr)."""
    import scipy.sparse as sp

    a = np.asarray(a_local)
    ed = np.asarray(eldofs)
    ne, nr, nc = a.shape
    rows = np.repeat(ed[:, :, None], nc, axis=2).ravel()
    cols = np.repeat(ed[:, None, :], nr, axis=1).ravel()
    mat = sp.coo_matrix(
        (a.ravel(), (rows, cols)), shape=(ndof, ndof_col or ndof)
    )
    return mat.tocsr()


def stiffness_local(space: FunctionSpace) -> np.ndarray:
    """(ne, nb, nb): int grad(phi_i) . grad(phi_j) on affine elements."""
    mesh = space.mesh
    rule = simplex_rule(mesh.dim, 2 * max(space.order - 1, 1))
    _, grads = space.basis.tabulate(rule.points)
    _, detJ, Jinv = mesh.element_jacobians
    g = np.einsum("eba,qib->eqia", Jinv, grads)
    return np.einsum("q,eqia,eqja,e->eij", rule.weights, g, g, detJ,
                     optimize=True)


def mass_diagonal(space: FunctionSpace) -> np.ndarray:
    """(ndof,) diagonal of the assembled mass matrix int phi_i phi_j
    (affine elements, quadrature degree 2 * max(order, 1))."""
    mesh = space.mesh
    rule = simplex_rule(mesh.dim, 2 * max(space.order, 1))
    vals, _ = space.basis.tabulate(rule.points)
    m_diag = np.einsum("q,qi,qi->i", rule.weights, vals, vals)
    _, detJ, _ = mesh.element_jacobians
    d = np.zeros(space.ndof)
    np.add.at(d, space.element_dofs.ravel(),
              (detJ[:, None] * m_diag[None, :]).ravel())
    return d

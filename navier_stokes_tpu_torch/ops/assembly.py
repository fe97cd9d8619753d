"""Assembly helpers: host-side setup (numpy / scipy) and the matrix-free
gather -> local matvec -> scatter apply (torch).

The parts of ``navier_stokes_tpu/ops/assembly.py`` that the port uses:
global CSR assembly of element matrices (the P1 coarse stiffness,
precond/twolevel.py), the P1 stiffness element tables, the pressure mass
diagonal behind ``preM`` (models/navier_stokes_mcs.py), and
``gather`` / ``scatter_add`` / ``diagonal_of_local`` /
``apply_local_matrices``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.quadrature import simplex_rule
from ..fem.spaces import FunctionSpace
from .local_mv import batched_local_matvec


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


# -- matrix-free applies and scatters (torch) --------------------------------


def gather(u: torch.Tensor, eldofs: torch.Tensor) -> torch.Tensor:
    return u[eldofs]


def scatter_add(local: torch.Tensor, eldofs: torch.Tensor,
                ndof: int) -> torch.Tensor:
    """(ne, nb) local contributions -> (ndof,) global vector
    (``index_add_``: on the card its float atomics add in an order that
    changes from run to run)."""
    out = local.new_zeros(ndof)
    return out.index_add_(0, eldofs.reshape(-1), local.reshape(-1))


def diagonal_of_local(a_local: torch.Tensor, eldofs: torch.Tensor,
                      ndof: int) -> torch.Tensor:
    """(ndof,) diagonal of the operator assembled from the element matrices
    (ne, nb, nb)."""
    return scatter_add(torch.diagonal(a_local, dim1=1, dim2=2), eldofs, ndof)


def apply_local_matrices(a_local: torch.Tensor, eldofs: torch.Tensor,
                         ndof: int, u: torch.Tensor,
                         use_kernel: bool = False) -> torch.Tensor:
    """y = A u with A given by per-element dense blocks (gather -> local
    matvec -> scatter).  ``use_kernel`` routes the batched local matvec
    through :func:`~navier_stokes_tpu_torch.ops.local_mv.batched_local_matvec`
    (``use_pallas`` of the JAX package); the einsum is the default."""
    ue = gather(u, eldofs)
    if use_kernel:
        ye = batched_local_matvec(a_local, ue.contiguous())
    else:
        ye = torch.einsum("eij,ej->ei", a_local, ue)
    return scatter_add(ye, eldofs, ndof)

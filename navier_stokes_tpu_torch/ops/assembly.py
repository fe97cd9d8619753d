"""Assembly helpers: host-side setup (numpy / scipy) and the matrix-free
gather -> local matvec -> scatter apply (torch).

The parts of ``navier_stokes_tpu/ops/assembly.py`` that the port uses:
global CSR assembly of element matrices (the P1 coarse stiffness,
precond/twolevel.py), the P1 stiffness element tables, the pressure mass
diagonal behind ``preM`` (models/navier_stokes_mcs.py), and
``gather`` / ``scatter_add`` / ``diagonal_of_local`` /
``apply_local_matrices``.

Every scatter-add of the port goes through :class:`ScatterPlan`: the
destinations of one index table are sorted once (stably), and each apply
is a gather of the contributions into an (ndof, multiplicity) table and a
sum over its rows -- no float atomics, so that the result is the same
from run to run on the card (``index_add_`` adds in an order that
changes).  The JAX package's scatters are deterministic on the TPU.
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


class ScatterPlan:
    """Deterministic scatter-add of per-entry contributions onto ``ndof``
    entries, for one fixed index table.

    ``index``: an integer tensor of any shape (element dofs (ne, nb), block
    dofs (nblocks, bmax), ...); entries < 0 are dropped.  Built once, on
    the index's device: a stable sort of the destinations gives, per
    destination, the positions of its contributions in their original order,
    padded to the largest multiplicity with a position that reads zero.
    ``plan(values)`` (values of ``index``'s shape) gathers them and sums
    each row: a gather and a reduction in a fixed order.  ``plan.index`` is
    the index table (long), for the matching gathers."""

    def __init__(self, index, ndof: int):
        index = torch.as_tensor(index)
        self.index = index.long()
        self.ndof = int(ndof)
        self.shape = tuple(index.shape)
        flat = self.index.reshape(-1)
        if flat.numel() and int(flat.max()) >= self.ndof:
            raise ValueError(f"ScatterPlan: index {int(flat.max())} out of "
                             f"range for {self.ndof} entries")
        pos = torch.nonzero(flat >= 0).reshape(-1)
        dst, perm = torch.sort(flat[pos], stable=True)
        src = pos[perm]
        counts = torch.bincount(dst, minlength=self.ndof)
        self.width = width = int(counts.max()) if dst.numel() else 0
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(dst.numel(), device=flat.device) - starts[dst]
        # position flat.numel() reads the zero appended to the values
        table = torch.full((self.ndof, max(width, 1)), flat.numel(),
                           dtype=torch.long, device=flat.device)
        table[dst, slot] = src
        self.table = table

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        if tuple(values.shape) != self.shape:
            raise ValueError(f"ScatterPlan: values of shape "
                             f"{tuple(values.shape)}, expected {self.shape}")
        ext = torch.cat([values.reshape(-1), values.new_zeros(1)])
        return ext[self.table].sum(dim=1)


def scatter_plan(index, ndof: int) -> ScatterPlan:
    """The :class:`ScatterPlan` of ``index`` (returned as is when it is
    one already)."""
    if isinstance(index, ScatterPlan):
        if index.ndof != ndof:
            raise ValueError(f"ScatterPlan onto {index.ndof} entries, "
                             f"{ndof} asked")
        return index
    return ScatterPlan(index, ndof)


def scatter_add(local: torch.Tensor, eldofs, ndof: int) -> torch.Tensor:
    """(ne, nb) local contributions -> (ndof,) global vector, summed in a
    fixed order.  ``eldofs``: a :class:`ScatterPlan` (build it once for an
    index table applied more than once) or the index tensor itself."""
    return scatter_plan(eldofs, ndof)(local)


def diagonal_of_local(a_local: torch.Tensor, eldofs, ndof: int
                      ) -> torch.Tensor:
    """(ndof,) diagonal of the operator assembled from the element matrices
    (ne, nb, nb)."""
    return scatter_add(torch.diagonal(a_local, dim1=1, dim2=2), eldofs, ndof)


def apply_local_matrices(a_local: torch.Tensor, eldofs, ndof: int,
                         u: torch.Tensor,
                         use_kernel: bool = False) -> torch.Tensor:
    """y = A u with A given by per-element dense blocks (gather -> local
    matvec -> scatter).  ``eldofs``: the (ne, nb) dof table or its
    :class:`ScatterPlan`.  ``use_kernel`` routes the batched local matvec
    through :func:`~navier_stokes_tpu_torch.ops.local_mv.batched_local_matvec`
    (``use_pallas`` of the JAX package); the einsum is the default."""
    plan = scatter_plan(eldofs, ndof)
    ue = gather(u, plan.index)
    if use_kernel:
        ye = batched_local_matvec(a_local, ue.contiguous())
    else:
        ye = torch.einsum("eij,ej->ei", a_local, ue)
    return plan(ye)

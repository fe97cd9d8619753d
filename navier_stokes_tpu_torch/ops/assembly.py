"""Assembly helpers: host-side setup (numpy / scipy) and the matrix-free
gather -> local matvec -> scatter apply (torch).

The parts of ``navier_stokes_tpu/ops/assembly.py`` that the port uses:
global CSR assembly of element matrices (the P1 coarse stiffness,
precond/twolevel.py; ``assemble_csr_rect`` for a rectangular operator),
the stiffness element tables, the pressure mass diagonal behind ``preM``
(models/navier_stokes_mcs.py), the tables of a (space, quadrature) pair
with their element forms (``SpaceTables``, ``make_tables``,
``mass_local``, ``stiffness_local``, ``phys_grad``, ``divergence_local``,
``linear_form_local``: torch on the tables' device, as the Taylor-Hood
model and the Stokes catalog use them), and ``gather`` / ``scatter_add`` /
``diagonal_of_local`` / ``apply_local_matrices``.

Every scatter-add of the port goes through :class:`ScatterPlan`: the
destinations of one index table are sorted once (stably), and each apply
is a gather of the contributions into an (ndof, multiplicity) table and a
sum over its rows -- no float atomics, so that the result is the same
from run to run on the card (``index_add_`` adds in an order that
changes).  The JAX package's scatters are deterministic on the TPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
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


def assemble_csr_rect(a_local, row_dofs, col_dofs, nrow: int, ncol: int):
    """scipy CSR of a rectangular operator from element matrices
    (ne, nr, nc) with row dofs (ne, nr) and column dofs (ne, nc)."""
    import scipy.sparse as sp

    a = np.asarray(a_local)
    rd, cd = np.asarray(row_dofs), np.asarray(col_dofs)
    ne, nr, nc = a.shape
    rows = np.repeat(rd[:, :, None], nc, axis=2).ravel()
    cols = np.repeat(cd[:, None, :], nr, axis=1).ravel()
    return sp.coo_matrix((a.ravel(), (rows, cols)),
                         shape=(nrow, ncol)).tocsr()


@dataclass(frozen=True)
class SpaceTables:
    """Static tables for one (space, quadrature) pair, as torch tensors on
    one device: affine geometry gives detj (ne,) and jinv (ne, d, d), an
    isoparametric one detj (ne, nq) and jinv (ne, nq, d, d)."""

    qw: torch.Tensor  # (nq,) quadrature weights
    val: torch.Tensor  # (nq, nb) basis values at quad points
    grad: torch.Tensor  # (nq, nb, d) reference gradients
    detj: torch.Tensor  # (ne,) or (ne, nq)
    jinv: torch.Tensor  # (ne, d, d) or (ne, nq, d, d)
    eldofs: torch.Tensor  # (ne, nb) int64
    qpts: torch.Tensor  # (ne, nq, d) physical quadrature points
    ndof: int


def make_tables(space: FunctionSpace, quad_degree: int | None = None,
                dtype=torch.float64, geometry=None,
                device=None) -> SpaceTables:
    """Tabulate basis + geometry for ``space`` at a shared quadrature rule,
    in ``dtype`` on ``device``.

    ``geometry``: optional mesh.curved.CurvedGeometry -- switches to
    isoparametric per-quadrature-point Jacobians."""
    device = resolve_device(device)
    mesh = space.mesh
    if quad_degree is None:
        quad_degree = 2 * max(space.order, 1)
        if geometry is not None:
            quad_degree += 2 * (geometry.order - 1)
    rule = simplex_rule(mesh.dim, quad_degree)
    vals, grads = space.basis.tabulate(rule.points)
    if geometry is not None:
        from ..mesh.curved import geometry_tables

        _, detJ, Jinv, qpts = geometry_tables(geometry, rule.points)
    else:
        J, detJ, Jinv = mesh.element_jacobians
        v0 = mesh.points[mesh.elements[:, 0]]
        qpts = v0[:, None, :] + np.einsum("eab,qb->eqa", J, rule.points)

    def ship(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    return SpaceTables(
        qw=ship(rule.weights), val=ship(vals), grad=ship(grads),
        detj=ship(detJ), jinv=ship(Jinv),
        eldofs=torch.as_tensor(space.element_dofs.astype(np.int64),
                               device=device),
        qpts=ship(qpts), ndof=space.ndof)


def mass_local(t: SpaceTables) -> torch.Tensor:
    """(ne, nb, nb): integral phi_i phi_j per element."""
    if t.detj.dim() == 1:  # affine
        m_ref = torch.einsum("q,qi,qj->ij", t.qw, t.val, t.val)
        return t.detj[:, None, None] * m_ref[None]
    return torch.einsum("q,qi,qj,eq->eij", t.qw, t.val, t.val, t.detj)


def phys_grad(t: SpaceTables) -> torch.Tensor:
    """(ne, nq, nb, d): physical basis gradients at quadrature points,
    (grad_x phi)_a = Jinv[b,a] d_b phi, for affine (ne,d,d) and
    isoparametric (ne,nq,d,d) Jacobians."""
    if t.jinv.dim() == 3:
        return torch.einsum("eba,qib->eqia", t.jinv, t.grad)
    return torch.einsum("eqba,qib->eqia", t.jinv, t.grad)


def divergence_local(tp: SpaceTables, tu: SpaceTables) -> torch.Tensor:
    """(ne, nbp, nbu, d): integral psi_i d_c(phi_j) per element; contracting
    with velocity component c gives the coupling b = integral div(u) q of
    reference run.py:80-81.  tp and tu share the mesh and the rule."""
    gu = phys_grad(tu)
    if tp.detj.dim() == 1:
        return torch.einsum("q,qi,eqjc,e->eijc", tp.qw, tp.val, gu, tp.detj)
    return torch.einsum("q,qi,eqjc,eq->eijc", tp.qw, tp.val, gu, tp.detj)


def linear_form_local(t: SpaceTables, f_qvals: torch.Tensor) -> torch.Tensor:
    """(ne, nb): integral f phi_i with f given at the physical quadrature
    points (ne, nq)."""
    if t.detj.dim() == 1:
        return torch.einsum("q,eq,qi,e->ei", t.qw, f_qvals, t.val, t.detj)
    return torch.einsum("q,eq,qi,eq->ei", t.qw, f_qvals, t.val, t.detj)


def stiffness_local(space):
    """(ne, nb, nb): int grad(phi_i) . grad(phi_j) per element -- from a
    :class:`SpaceTables` (torch, as the JAX package's tables form) or from
    a space on affine elements (numpy, host setup)."""
    if isinstance(space, SpaceTables):
        t = space
        g = phys_grad(t)
        if t.detj.dim() == 1:
            return torch.einsum("q,eqia,eqja,e->eij", t.qw, g, g, t.detj)
        return torch.einsum("q,eqia,eqja,eq->eij", t.qw, g, g, t.detj)
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

"""Two-level additive Schwarz preconditioner for H1-type operators, and the
coarse P1 solve of the auxiliary-space preconditioners.

Counterpart of ``navier_stokes_tpu/precond/twolevel.py``:

* fine level: vertex-patch block-Jacobi (batched dense block inverses,
  applied as gather -> batched block matvec -> scatter-add,
  precond/jacobi.py), or plain Jacobi;
* coarse level: the embedded P1 space on the same mesh and Dirichlet
  boundary (for nested Lagrange spaces the Galerkin coarse operator IS the
  P1 stiffness matrix), its stiffness assembled on the host, solved by a
  precomputed dense f64 inverse stored in ``dtype`` on the device for up to
  ``dense_limit`` free dofs (one ``torch.matmul``; the JAX package leaves it
  to XLA as well) and by a smoothed-aggregation AMG V-cycle
  (precond/amg.py) above.

The additive combination keeps the preconditioner SPD.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..fem.spaces import H1, FunctionSpace
from ..ops.assembly import (
    ScatterPlan,
    assemble_csr,
    diagonal_of_local,
    stiffness_local,
)
from .amg import build_sa_amg
from .jacobi import block_jacobi, extract_blocks_from_local, jacobi

__all__ = ["p1_embedding", "coarse_p1_solver", "vertex_patch_blocks",
           "two_level_preconditioner"]


def p1_embedding(space: FunctionSpace, dtype=torch.float64, device=None):
    """(P, PT): embed P1 vertex functions into ``space`` and its transpose.

    P maps coarse (nv,) -> fine (ndof,) by interpolation (exact for nested
    Lagrange spaces); PT is the exact transpose."""
    device = resolve_device(device)
    mesh = space.mesh
    basis = space.basis
    nodes = basis.nodes  # (nb, dim) reference interpolation points
    if nodes is None:
        raise ValueError("p1_embedding requires an interpolatory basis")
    # barycentric hat values at the reference nodes
    lam = np.concatenate(
        [1.0 - nodes.sum(axis=1, keepdims=True), nodes], axis=1
    )  # (nb, dim+1)
    if not basis.nodal:
        vn, _ = basis.tabulate(nodes)
        lam = np.linalg.inv(vn) @ lam  # coefficients, not values
    eldofs = torch.as_tensor(space.element_dofs.astype(np.int64),
                             device=device)
    elverts = torch.as_tensor(mesh.elements.astype(np.int64), device=device)
    ndof, nv = space.ndof, mesh.nv
    # multiplicity weights so the overlapping scatter averages to the value
    mult = np.zeros(ndof)
    np.add.at(mult, space.element_dofs.ravel(), 1.0)
    winv = torch.as_tensor(1.0 / np.maximum(mult, 1.0),
                           device=device).to(dtype)
    lam_t = torch.as_tensor(lam, device=device).to(dtype)
    to_fine, to_coarse = ScatterPlan(eldofs, ndof), ScatterPlan(elverts, nv)

    def P(c):
        fe = c[elverts] @ lam_t.T  # (ne, dim+1) -> (ne, nb)
        return winv * to_fine(fe)

    def PT(x):
        ce = (winv * x)[eldofs] @ lam_t  # (ne, nb) -> (ne, dim+1)
        return to_coarse(ce)

    return P, PT


def coarse_p1_solver(space: FunctionSpace, coefficient: float = 1.0,
                     dtype=torch.float32, device=None,
                     dense_limit: int = 5000):
    """Apply r_coarse -> ~Kc^{-1} r_coarse (zero on constrained coarse dofs)
    for r of shape (nv,) or (nv, k): the dense inverse up to ``dense_limit``
    free dofs, one SA-AMG V-cycle above."""
    device = resolve_device(device)
    coarse = H1(space.mesh, 1, dirichlet=space.dirichlet_names)
    Kc = assemble_csr(stiffness_local(coarse), coarse.element_dofs,
                      coarse.ndof) * coefficient
    free_mask = coarse.free_mask
    free = np.where(free_mask)[0]
    nv = coarse.ndof
    if len(free) > dense_limit:
        return build_sa_amg(Kc, free_mask, dtype, device)
    Kff = np.asarray(Kc[free][:, free].todense())
    inv = torch.as_tensor(np.linalg.inv(Kff), device=device).to(dtype)
    free_t = torch.as_tensor(free, device=device)

    def solve(r):
        out = r.new_zeros((nv,) + tuple(r.shape[1:]))
        out[free_t] = inv @ r[free_t]
        return out

    return solve


def vertex_patch_blocks(space: FunctionSpace) -> list[np.ndarray]:
    """Free-dof blocks: per mesh vertex, its dof + the dofs of incident
    edges (and faces in 3D); one more block per element for the interior
    dofs, so that every free dof is covered and the additive preconditioner
    stays definite."""
    mesh, b = space.mesh, space.basis
    free = space.free_mask
    blocks: list[list[int]] = [[] for _ in range(mesh.nv)]
    if b.n_vertex:
        for v in range(mesh.nv):
            blocks[v].append(v)
    off = mesh.nv * b.n_vertex
    if b.n_edge:
        for eid, (a, bb) in enumerate(mesh.edges.tolist()):
            dofs = list(range(off + eid * b.n_edge,
                              off + (eid + 1) * b.n_edge))
            blocks[a].extend(dofs)
            blocks[bb].extend(dofs)
    if mesh.dim == 3 and b.n_face:
        off_f = off + mesh.nedge * b.n_edge
        for fid, verts in enumerate(mesh.faces.tolist()):
            dofs = list(range(off_f + fid * b.n_face,
                              off_f + (fid + 1) * b.n_face))
            for v in verts:
                blocks[v].extend(dofs)
    if b.n_cell:
        off_c = (
            mesh.nv * b.n_vertex
            + mesh.nedge * b.n_edge
            + (len(mesh.faces) * b.n_face if mesh.dim == 3 else 0)
        )
        for e in range(mesh.ne):
            blocks.append(
                list(range(off_c + e * b.n_cell, off_c + (e + 1) * b.n_cell))
            )
    out = []
    for blk in blocks:
        blk = [d for d in blk if free[d]]
        if blk:
            out.append(np.asarray(blk, dtype=np.int32))
    return out


def two_level_preconditioner(space: FunctionSpace, a_local: np.ndarray,
                             coefficient: float = 1.0,
                             smoother: str = "patch", dtype=torch.float64,
                             device=None):
    """Additive two-level preconditioner for the masked operator built from
    the element matrices ``a_local`` (ne, nb, nb) on ``space``:
    smoother + P Kc^{-1} P^T.

    ``coefficient`` scales the coarse P1 stiffness (e.g. the viscosity)."""
    device = resolve_device(device)
    free = torch.as_tensor(space.free_mask, device=device)
    P, PT = p1_embedding(space, dtype, device)
    coarse = coarse_p1_solver(space, coefficient, dtype, device)

    if smoother == "patch":
        dofs, mats = extract_blocks_from_local(
            np.asarray(a_local), space.element_dofs,
            vertex_patch_blocks(space), space.ndof)
        smooth = block_jacobi(dofs, mats, space.ndof, dtype, device)
    elif smoother == "jacobi":
        diag = diagonal_of_local(
            torch.as_tensor(np.asarray(a_local), device=device).to(dtype),
            torch.as_tensor(space.element_dofs.astype(np.int64),
                            device=device), space.ndof)
        smooth = jacobi(torch.where(free, diag, 1.0))
    else:
        raise ValueError(smoother)

    def pre(x):
        xf = torch.where(free, x, 0.0)
        y = smooth(xf) + P(coarse(PT(xf)))
        return torch.where(free, y, x)

    return pre

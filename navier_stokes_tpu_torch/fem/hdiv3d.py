"""H(div)-conforming BDM and RT elements on tetrahedra.

3D extension of fem/hdiv.py (the NGSolve HDiv space on tets, SURVEY.md
section 2b row 2).  BDM_k = [P_k]^3 with face dofs = moments of the normal
trace against the orthonormal 2D Dubiner basis on the face; RT_k =
[P_k]^3 + x * (homogeneous P_k) with the same face moments (``rt_tet``,
``HDiv3D(RT=True)``).

Orientation strategy: face moments are defined in the face's GLOBAL frame —
the face is parametrized from its sorted global vertices
x(s,t) = X_g0 + s (X_g1 - X_g0) + t (X_g2 - X_g0), and the Piola identity
int_F (v.n) q dS = int_ref (vhat . nhat_sorted) q ds makes the moment
value identical from both neighboring tets.  Each element's basis is built
(dual delta basis via pinv + interior nullspace) for its specific
combination of face orientations; bases are cached per orientation combo
(at most 6^4, ~tens in practice), and tabulation returns per-element
tables, which is what the batched assembly consumes anyway.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..mesh.mesh import Mesh
from .quadrature import triangle_rule
from .reference import TET_FACES, TET_VERTICES, tet_modal, triangle_modal


def _vector_modal_eval_3d(points: np.ndarray, order: int):
    v, g = tet_modal(points, order)
    M = v.shape[1]
    npts = len(points)
    vals = np.zeros((npts, 3 * M, 3))
    grads = np.zeros((npts, 3 * M, 3, 3))
    for c in range(3):
        vals[:, c * M:(c + 1) * M, c] = v
        grads[:, c * M:(c + 1) * M, c, :] = g
    return vals, grads


def face_frame(local_perm: tuple[int, int, int], lf: int):
    """Reference-coordinate parametrization data of local face ``lf`` with
    vertex order ``local_perm`` (indices into the face's local vertices,
    giving the sorted-global order).

    Returns (origin (3,), e1 (3,), e2 (3,), n_scaled (3,)): the face map is
    x(s,t) = origin + s e1 + t e2 over the unit triangle, n_scaled = e1 x e2.
    """
    verts = [TET_VERTICES[TET_FACES[lf][p]] for p in local_perm]
    origin = verts[0]
    e1 = verts[1] - verts[0]
    e2 = verts[2] - verts[0]
    n = np.cross(e1, e2)
    return origin, e1, e2, n


@dataclass(frozen=True)
class TetBDMBasis:
    """BDM_k basis for one face-orientation combo."""

    order: int
    n_basis: int
    n_face: int
    n_cell: int
    coeffs: np.ndarray  # (nb, 3M)
    combo: tuple

    def tabulate(self, points: np.ndarray):
        vals, grads = _vector_modal_eval_3d(points, self.order)
        return (
            np.einsum("pmc,nm->pnc", vals, self.coeffs),
            np.einsum("pmcd,nm->pncd", grads, self.coeffs),
        )


def bdm_tet(order: int, combo: tuple) -> TetBDMBasis:
    """BDM_k basis on the reference tet with face moments in the global
    frames given by ``combo`` = 4 permutations of each face's vertices."""
    k = order
    M = (k + 1) * (k + 2) * (k + 3) // 6
    dim = 3 * M
    nfd = (k + 1) * (k + 2) // 2
    q2 = triangle_rule(2 * k + 2)
    fvals, _ = triangle_modal(q2.points, k)  # orthonormal on the unit tri

    rows = []
    for lf in range(4):
        origin, e1, e2, n = face_frame(combo[lf], lf)
        pts = (
            origin[None, :]
            + q2.points[:, 0:1] * e1[None, :]
            + q2.points[:, 1:2] * e2[None, :]
        )
        vm, _ = _vector_modal_eval_3d(pts, k)  # (nq, dim, 3)
        vn = vm @ n  # (nq, dim)
        for j in range(nfd):
            rows.append(np.einsum("q,q,qn->n", q2.weights, fvals[:, j], vn))
    L = np.stack(rows)  # (4 nfd, dim)
    W_face = np.linalg.pinv(L)
    _, s, Vt = np.linalg.svd(L)
    null = Vt[np.linalg.matrix_rank(L, tol=1e-9):].T
    coeffs = np.concatenate([W_face, null], axis=1).T
    assert coeffs.shape[0] == dim
    return TetBDMBasis(
        order=k, n_basis=dim, n_face=nfd, n_cell=dim - 4 * nfd,
        coeffs=coeffs, combo=combo,
    )


def rt_tet(order: int, combo: tuple) -> TetBDMBasis:
    """RT_k on the reference tet: [P_k]^3 + x * (homogeneous P_k), face
    moments against P_k in the global frames of ``combo`` (2D analogue:
    fem/hdiv.py::rt_triangle)."""
    k = order
    kk = k + 1  # RT_k lives inside [P_{k+1}]^3
    M = (kk + 1) * (kk + 2) * (kk + 3) // 6
    dim_big = 3 * M
    # spanning set fitted in the degree-(k+1) vector modal frame
    rng = np.random.default_rng(0)
    pts = rng.random((6 * dim_big, 3))
    pts = pts[pts.sum(1) < 0.98]
    vm, _ = _vector_modal_eval_3d(pts, kk)
    span = []
    vk, _ = tet_modal(pts, k)
    for m in range(vk.shape[1]):
        for c in range(3):
            col = np.zeros((len(pts), 3))
            col[:, c] = vk[:, m]
            span.append(col)
    for i in range(k + 1):  # x * homogeneous monomials x^a y^b z^(k-a-b)
        for j in range(k + 1 - i):
            mono = pts[:, 0] ** i * pts[:, 1] ** j * pts[:, 2] ** (k - i - j)
            span.append(pts * mono[:, None])
    vm2 = vm.transpose(0, 2, 1).reshape(-1, dim_big)
    coeff_span = []
    for fcol in span:
        c, *_ = np.linalg.lstsq(vm2, fcol.reshape(-1), rcond=None)
        coeff_span.append(c)
    S = np.stack(coeff_span)
    q, r = np.linalg.qr(S.T)
    rank = int(np.sum(np.abs(np.diag(r)) > 1e-9))
    basis_rt = q[:, :rank].T  # (nrt, dim_big)

    nfd = (k + 1) * (k + 2) // 2
    q2 = triangle_rule(2 * k + 4)
    fvals, _ = triangle_modal(q2.points, k)
    rows = []
    for lf in range(4):
        origin, e1, e2, n = face_frame(combo[lf], lf)
        pts_f = (
            origin[None] + q2.points[:, :1] * e1[None]
            + q2.points[:, 1:2] * e2[None]
        )
        vm_f, _ = _vector_modal_eval_3d(pts_f, kk)
        vn = np.einsum("qnc,c->qn", vm_f, n) @ basis_rt.T  # RT frame
        for j in range(nfd):
            rows.append(np.einsum("q,q,qn->n", q2.weights, fvals[:, j], vn))
    L = np.stack(rows)
    W_face = np.linalg.pinv(L)
    _, _, Vt = np.linalg.svd(L)
    null = Vt[np.linalg.matrix_rank(L, tol=1e-9):].T
    coeffs_rt = np.concatenate([W_face, null], axis=1).T
    coeffs = coeffs_rt @ basis_rt  # back to the degree-(k+1) modal frame
    nb = coeffs.shape[0]
    return TetBDMBasis(
        order=kk, n_basis=nb, n_face=nfd, n_cell=nb - 4 * nfd,
        coeffs=coeffs, combo=combo,
    )


@dataclass
class HDivSpace3D:
    """Global 3D H(div) space: shared face dofs (global-frame moments, no
    signs needed) + cell dofs.  Per-element bases via the combo cache."""

    mesh: Mesh
    order: int
    ndof: int
    element_dofs: np.ndarray  # (ne, nb) int32
    combo_ids: np.ndarray  # (ne,) int32 into ``bases``
    bases: list[TetBDMBasis]
    dirichlet_names: str = ""
    name: str = "HDiv3D"

    @property
    def n_face_dofs(self) -> int:
        return self.bases[0].n_face

    @property
    def n_basis(self) -> int:
        return self.bases[0].n_basis

    @cached_property
    def free_mask(self) -> np.ndarray:
        return ~self.boundary_dof_mask(self.dirichlet_names)

    def boundary_dof_mask(self, names: str) -> np.ndarray:
        mask = np.zeros(self.ndof, dtype=bool)
        if not names:
            return mask
        nfd = self.n_face_dofs
        for f in self.mesh.boundary_facet_ids(names):
            mask[f * nfd: (f + 1) * nfd] = True
        return mask

    def tabulate_elements(self, points: np.ndarray):
        """Per-element reference tabulations: (vals (ne, nq, nb, 3),
        grads (ne, nq, nb, 3, 3)) gathered from the combo cache."""
        tabs = [b.tabulate(points) for b in self.bases]
        vals = np.stack([t[0] for t in tabs])  # (ncombo, nq, nb, 3)
        grads = np.stack([t[1] for t in tabs])
        return vals[self.combo_ids], grads[self.combo_ids]


def HDiv3D(mesh: Mesh, order: int, dirichlet: str = "",
           RT: bool = False) -> HDivSpace3D:
    """The global 3D H(div) space of BDM_k elements, or of RT_k with
    ``RT=True`` (:func:`rt_tet`)."""
    assert mesh.dim == 3
    k = order
    nfd = (k + 1) * (k + 2) // 2
    ne = mesh.ne
    els = mesh.elements

    combos = {}
    combo_ids = np.zeros(ne, dtype=np.int32)
    combo_list: list[tuple] = []
    elem_combos = []
    for e in range(ne):
        perms = []
        for lf, fverts in enumerate(TET_FACES):
            gl = els[e, list(fverts)]
            perm = tuple(int(p) for p in np.argsort(gl))
            perms.append(perm)
        key = tuple(perms)
        if key not in combos:
            combos[key] = len(combo_list)
            combo_list.append(key)
        combo_ids[e] = combos[key]
        elem_combos.append(key)
    make = rt_tet if RT else bdm_tet
    bases = [make(order, c) for c in combo_list]

    nb = bases[0].n_basis
    nc_d = bases[0].n_cell
    off_c = mesh.nface * nfd
    ndof = off_c + ne * nc_d
    table = np.zeros((ne, nb), dtype=np.int64)
    col = 0
    for lf in range(4):
        base = mesh.element_faces[:, lf].astype(np.int64) * nfd
        for j in range(nfd):
            table[:, col] = base + j
            col += 1
    cells = np.arange(ne, dtype=np.int64)
    for m in range(nc_d):
        table[:, col] = off_c + cells * nc_d + m
        col += 1
    return HDivSpace3D(
        mesh, order, ndof, table.astype(np.int32), combo_ids, bases,
        dirichlet, name=f"{'RT' if RT else 'BDM'}{order}-3D",
    )

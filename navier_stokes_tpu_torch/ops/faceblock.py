"""Scatter-free face-block applies for 3D hybrid [H(div) | facet] operators.

Counterpart of ``navier_stokes_tpu/ops/faceblock.py``.  The dof vector is
viewed as an (nface, nfb) face-block matrix (H(div) face dofs + facet dofs
per mesh face) plus an (ne, n_int) interior matrix.  The element gather is
four block-row gathers; the scatter-add is its transpose gather, since
every face receives contributions from at most two (element, local-face)
slots.  Element tables are permuted once at setup into face-major order, so
an apply is: split -> 4-row block gather -> one batched block matvec
(ops/block_mv.py) -> 2-row block gather -> join.

Index plans are built on the host in numpy and moved to ``device`` once;
applies are plain functions on tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .block_mv import (
    block_mv,
    block_mv2,
    block_mv_comp,
    make_table_apply,
    split_f64,
)

__all__ = ["FaceBlockLayout", "FaceStarSmoother", "face_star_smoother"]


def _check_contiguous_rows(eldofs_p, ne: int, m: int) -> None:
    ed = np.asarray(eldofs_p)
    expected = np.arange(ne)[:, None] * m + np.arange(m)[None, :]
    assert np.array_equal(ed, expected), "pressure dofs not contiguous"


class FaceBlockLayout:
    """Index plan for scatter-free applies on a HybridVelocitySpace3D."""

    def __init__(self, Xv, device):
        mesh = Xv.mesh
        V, F = Xv.hdiv, Xv.facet
        self.mesh = mesh
        self.device = torch.device(device)
        self.nfd_v = V.n_face_dofs
        self.n_int = V.bases[0].n_cell
        self.nfd_f = F.n_face
        self.nfb = self.nfd_v + self.nfd_f
        self.ne, self.nface = mesh.ne, mesh.nface
        self.off_c = self.nface * self.nfd_v
        self.nhd = V.ndof
        self.n = Xv.ndof
        self.nb = 4 * self.nfd_v + self.n_int + 4 * self.nfd_f
        self.n_skel = 4 * self.nfb

        nfd_v, n_int, nfd_f = self.nfd_v, self.n_int, self.nfd_f
        # element-local permutation: flat order [4 x nfd_v hdiv | n_int |
        # 4 x nfd_f facet] -> face-major [face0 (hdiv+facet) ... face3 | int]
        self.perm = np.concatenate(
            [
                np.concatenate(
                    [lf * nfd_v + np.arange(nfd_v),
                     4 * nfd_v + n_int + lf * nfd_f + np.arange(nfd_f)]
                )
                for lf in range(4)
            ]
            + [4 * nfd_v + np.arange(n_int)]
        )
        # skeleton-only permutation: [4 x nfd_v | 4 x nfd_f] -> face-major
        self.perm_skel = np.concatenate(
            [
                np.concatenate(
                    [lf * nfd_v + np.arange(nfd_v),
                     4 * nfd_v + lf * nfd_f + np.arange(nfd_f)]
                )
                for lf in range(4)
            ]
        )

        efaces = np.asarray(mesh.element_faces).astype(np.int64)
        # transpose-gather plan: face -> its <=2 (element*4+lf) slots
        flat = efaces.ravel()
        order = np.argsort(flat, kind="stable").astype(np.int64)
        counts = np.bincount(flat, minlength=self.nface)
        starts = np.concatenate([[0], np.cumsum(counts)])
        pos = np.full((self.nface, 2), self.ne * 4, np.int64)
        pos[counts >= 1, 0] = order[starts[:-1][counts >= 1]]
        pos[counts >= 2, 1] = order[starts[:-1][counts >= 2] + 1]
        self.efaces = torch.as_tensor(efaces, device=self.device)
        self.pos = torch.as_tensor(pos, device=self.device)

    # -- host helpers ---------------------------------------------------

    def permute_blocks(self, A_np: np.ndarray) -> np.ndarray:
        """(ne, nb, nb) flat-order element blocks -> face-major order."""
        p = self.perm
        return np.ascontiguousarray(A_np[:, p[:, None], p[None, :]])

    def permute_skel_blocks(self, S_np: np.ndarray) -> np.ndarray:
        """(ne, 48, 48) skeleton blocks (loc_skel order) -> face-major."""
        p = self.perm_skel
        return np.ascontiguousarray(S_np[:, p[:, None], p[None, :]])

    def permute_cols(self, B_np: np.ndarray) -> np.ndarray:
        """(ne, m, nb) rectangular blocks: permute the element axis only."""
        return np.ascontiguousarray(B_np[:, :, self.perm])

    # -- layout conversions ------------------------------------------------

    def split(self, u):
        """Flat (n,) -> (uF (nface, nfb), ui (ne, n_int))."""
        uF = torch.cat(
            [
                u[: self.off_c].reshape(self.nface, self.nfd_v),
                u[self.nhd:].reshape(self.nface, self.nfd_f),
            ],
            dim=1,
        )
        ui = u[self.off_c: self.nhd].reshape(self.ne, self.n_int)
        return uF, ui

    def join(self, uF, ui):
        return torch.cat(
            [
                uF[:, : self.nfd_v].reshape(-1),
                ui.reshape(-1),
                uF[:, self.nfd_v:].reshape(-1),
            ]
        )

    def gather_skel(self, uF):
        """(ne, 4*nfb) skeleton element vectors, face-major."""
        return uF[self.efaces].reshape(self.ne, self.n_skel)

    def gather_elem(self, uF, ui):
        """(ne, nb) element vectors in face-major (permuted) order."""
        return torch.cat([self.gather_skel(uF), ui], dim=1)

    def scatter_skel(self, yf4):
        """(ne, 4*nfb) skeleton-only results -> yF (nface, nfb)."""
        yf = yf4.reshape(self.ne * 4, self.nfb)
        yf = torch.cat([yf, yf.new_zeros((1, self.nfb))])
        return yf[self.pos[:, 0]] + yf[self.pos[:, 1]]

    def scatter_elem(self, ye):
        """Transpose of gather_elem: (ne, nb) face-major element results ->
        (yF, yi) via the two-sibling gather (no scatter)."""
        return self.scatter_skel(ye[:, : self.n_skel]), ye[:, self.n_skel:]

    def _elem_io(self, u, kernel):
        uF, ui = self.split(u)
        ye = kernel(self.gather_elem(uF, ui).contiguous())
        yF, yi = self.scatter_elem(ye)
        return self.join(yF, yi)

    # -- f64 operators (plain tensor ops, as the JAX package's XLA einsums)

    def elem_apply(self, A_perm):
        """y = A u from face-major element blocks (ne, nb, nb), any dtype;
        the model's f64 operators."""
        return lambda u: self._elem_io(
            u, lambda ue: torch.einsum("eij,ej->ei", A_perm, ue))

    def rect_apply(self, B_perm, eldofs_p):
        """(B, BT) for a rectangular coupling (ne, m, nb) with
        element-contiguous row dofs (L2 pressure), face-major columns."""
        m = B_perm.shape[1]
        _check_contiguous_rows(eldofs_p, self.ne, m)

        def B(u):
            uF, ui = self.split(u)
            ue = self.gather_elem(uF, ui)
            return torch.einsum("epi,ei->ep", B_perm, ue).reshape(-1)

        def BT(p):
            pe = p.reshape(self.ne, m)
            ye = torch.einsum("epi,ep->ei", B_perm, pe)
            yF, yi = self.scatter_elem(ye)
            return self.join(yF, yi)

        return B, BT

    # -- f32 kernel operators ------------------------------------------------

    def pack_elem_tables(self, mats):
        """Contiguous f32 device copies of (ne, nb, nb) face-major tables,
        shared between :meth:`elem_apply_tiled` and :meth:`elem_apply_comp`
        (one copy of the split hi/lo tables serves both phases)."""
        out = []
        for A in mats:
            if isinstance(A, np.ndarray):
                A = torch.from_numpy(np.ascontiguousarray(A))
            out.append(A.to(device=self.device, dtype=torch.float32)
                       .contiguous())
        return out

    def elem_apply_multi(self, mats_and_scales):
        """y = sum_k c_k * (A_k u) sharing one gather/scatter round trip,
        each term a :func:`block_mv` of an f32 table (numpy or tensor)."""
        tabs = [(self.pack_elem_tables([A])[0], c)
                for A, c in mats_and_scales]

        def kernel(ue):
            ye = None
            for A, c in tabs:
                t = block_mv(A, ue)
                t = t if c is None else c * t
                ye = t if ye is None else ye + t
            return ye

        return lambda u: self._elem_io(u, kernel)

    def elem_apply_tiled(self, tabs):
        """y = (sum_k A_k) u for one f32 device table (:func:`block_mv`) or
        the split hi/lo pair in ONE stream (:func:`block_mv2`); ``tabs``
        from :meth:`pack_elem_tables`."""
        tabs = list(tabs)
        if len(tabs) == 1:
            kernel = lambda ue: block_mv(tabs[0], ue)
        elif len(tabs) == 2:
            kernel = lambda ue: block_mv2(tabs[0], tabs[1], ue)
        else:
            raise ValueError("elem_apply_tiled takes one table or a pair")

        def apply(u):
            return self._elem_io(u.to(torch.float32), kernel)

        apply.tables = tabs
        return apply

    def elem_apply_comp(self, Ah, Al):
        """COMPENSATED double-single apply: y (f64) = (A_hi + A_lo) u (f64)
        through :func:`block_mv_comp` at f32 streaming speed; the f32 device
        tables may be the ones :meth:`elem_apply_tiled` streams."""

        def kernel(ue):
            yh, yl = block_mv_comp(Ah, Al, *split_f64(ue))
            return yh.to(torch.float64) + yl.to(torch.float64)

        def apply(u):
            return self._elem_io(u, kernel)

        apply.tables = [Ah, Al]
        return apply

    def rect_apply_multi(self, fwd, eldofs_p):
        """(B, BT) applying sum_k B_k (one f32 device table or the split
        pair, (ne, m, nb)) through :func:`block_mv` / :func:`block_mv2`; BT
        streams a transposed copy of the blocks made at setup."""
        fwd = list(fwd)
        m = fwd[0].shape[1]
        _check_contiguous_rows(eldofs_p, self.ne, m)
        bwd = [t.transpose(1, 2).contiguous() for t in fwd]

        def bmv(tabs, x):
            if len(tabs) == 1:
                return block_mv(tabs[0], x)
            return block_mv2(tabs[0], tabs[1], x)

        def B(u):
            uF, ui = self.split(u)
            ue = self.gather_elem(uF, ui).contiguous()
            return bmv(fwd, ue).reshape(-1)

        def BT(p):
            ye = bmv(bwd, p.reshape(self.ne, m).contiguous())
            yF, yi = self.scatter_elem(ye)
            return self.join(yF, yi)

        B.tables, BT.tables = fwd, bwd
        return B, BT

    def rect_apply_comp(self, fh, fl, eldofs_p):
        """Compensated (B, BT) for the pressure coupling (f64 in and out)
        from f32 device tables (ne, m, nb) through :func:`block_mv_comp`;
        BT streams transposed copies."""
        m = fh.shape[1]
        _check_contiguous_rows(eldofs_p, self.ne, m)
        th, tl = fh.transpose(1, 2).contiguous(), fl.transpose(1, 2).contiguous()

        def comp(hi, lo, x):
            yh, yl = block_mv_comp(hi, lo, *split_f64(x))
            return yh.to(torch.float64) + yl.to(torch.float64)

        def B(u):
            uF, ui = self.split(u)
            return comp(fh, fl, self.gather_elem(uF, ui)).reshape(-1)

        def BT(p):
            ye = comp(th, tl, p.reshape(self.ne, m))
            yF, yi = self.scatter_elem(ye)
            return self.join(yF, yi)

        B.tables, BT.tables = [fh, fl], [th, tl]
        return B, BT


# ----------------------------------------------------------------------
# Face-granular overlapping block smoother (edge-star patches)
# ----------------------------------------------------------------------


class FaceStarSmoother:
    """Overlapping additive block-Jacobi over FACE-granular patches (the
    edge-stars: the faces around each mesh edge), every index op a
    block-row gather of slice nfb.

    Blocks are bucketed by face count; each bucket is one batched block
    matvec (:func:`~navier_stokes_tpu_torch.ops.block_mv.block_mv`) with its
    f64-inverted blocks stored in ``dtype``.  The scatter back is the
    transpose-gather: every face belongs to exactly THREE edge-stars.

    Constrained (Dirichlet) dofs are decoupled by zeroing their block
    rows/columns and placing 1 on the diagonal before inversion.  The
    blocks are assembled in f64 from the face-major skeleton element table
    ``S5p`` by gathers (the face-level entry (f_i, f_j) sums the element
    sub-blocks of the elements adjacent to both faces) and inverted in f64
    (``torch.linalg.inv``), on ``layout.device``.
    """

    def __init__(self, layout: FaceBlockLayout, S_perm, edge_faces,
                 freeF: np.ndarray, dtype=torch.float32):
        nfb, nface, ne = layout.nfb, layout.nface, layout.ne
        dev = layout.device
        self.layout = layout
        S = torch.as_tensor(np.asarray(S_perm), dtype=torch.float64,
                            device=dev)
        S5p = torch.cat([S.reshape(ne, 4, nfb, 4, nfb),
                         S.new_zeros((1, 4, nfb, 4, nfb))])
        freeF_dev = torch.as_tensor(freeF, device=dev)

        sizes = np.array([len(f) for f in edge_faces])
        order = np.argsort(sizes, kind="stable")
        pos_np = layout.pos.cpu().numpy()  # topology only
        pos3 = np.full((nface, 3), -1, np.int64)
        cnt = np.zeros(nface, np.int32)
        self.buckets = []  # (faces_b tensor, table apply)
        slot_base = 0
        for fsz in np.unique(sizes):
            sel = order[sizes[order] == fsz]
            faces_b = np.stack([np.asarray(edge_faces[i]) for i in sel])
            inv = _bucket_inverses(S5p, faces_b, pos_np, freeF_dev,
                                   nfb, ne)
            for b, i in enumerate(sel):
                for k, f in enumerate(edge_faces[i]):
                    pos3[f, cnt[f]] = slot_base + b * fsz + k
                    cnt[f] += 1
            self.buckets.append(
                (torch.as_tensor(faces_b, device=dev),
                 make_table_apply(inv, store_dtype=dtype))
            )
            slot_base += len(sel) * fsz
        assert cnt.max() <= 3
        pos3 = np.where(pos3 < 0, slot_base, pos3)  # pad -> zero row
        self.pos3 = torch.as_tensor(pos3, device=dev)
        self.freeF = freeF_dev

    def smooth_faces(self, xF):
        """Additive Schwarz: yF = sum_blocks P_b S_b^{-1} P_b^T xF."""
        nfb = self.layout.nfb
        xF = torch.where(self.freeF, xF, 0.0)
        parts = []
        for faces_b, solve in self.buckets:
            nb_b, fsz = faces_b.shape
            xb = xF[faces_b].reshape(nb_b, fsz * nfb)
            parts.append(solve(xb).reshape(nb_b * fsz, nfb))
        slots = torch.cat(parts + [xF.new_zeros((1, nfb))])
        yF = (slots[self.pos3[:, 0]] + slots[self.pos3[:, 1]]
              + slots[self.pos3[:, 2]])
        return torch.where(self.freeF, yF, 0.0)


def _bucket_inverses(S5p, faces_b, pos_np, freeF_dev, nfb, ne,
                     chunk_bytes: float = 2.5e8):
    """One bucket's edge-star blocks, gathered from the face-major skeleton
    table (plus one zero element) and inverted in f64.

    Diagonal face blocks sum the face's (up to) two adjacent elements;
    off-diagonal blocks come from the one element shared by faces i and j
    (two distinct tets share at most one face).  Index plans are topology
    only (host numpy)."""
    nb_b, fsz = faces_b.shape
    bdim = fsz * nfb
    p2 = pos_np[faces_b]  # (nb_b, fsz, 2): elem*4+lf, pad ne*4
    el = p2 // 4
    lf = p2 % 4
    ar = np.arange(fsz)
    E = np.full((2, nb_b, fsz, fsz), ne, np.int64)
    LI = np.zeros((2, nb_b, fsz, fsz), np.int64)
    LJ = np.zeros((2, nb_b, fsz, fsz), np.int64)
    for s in (0, 1):  # diagonal: both adjacent elements
        E[s, :, ar, ar] = el[:, :, s].T
        LI[s, :, ar, ar] = lf[:, :, s].T
        LJ[s, :, ar, ar] = lf[:, :, s].T
    # off-diagonal: the one element shared by faces i and j
    eli = el[:, :, None, :, None]
    elj = el[:, None, :, None, :]
    diag = np.eye(fsz, dtype=bool)[None, :, :, None, None]
    m4 = (eli == elj) & (eli != ne) & ~diag
    lfi = lf[:, :, None, :, None]
    lfj = lf[:, None, :, None, :]
    e_off = (m4 * (eli + 1)).sum((3, 4)) - 1
    li_off = (m4 * (lfi + 1)).sum((3, 4)) - 1
    lj_off = (m4 * (lfj + 1)).sum((3, 4)) - 1
    off = e_off >= 0
    E[0] = np.where(off, e_off, E[0])
    LI[0] = np.where(off, li_off, LI[0])
    LJ[0] = np.where(off, lj_off, LJ[0])

    dev = S5p.device
    faces_t = torch.as_tensor(faces_b, device=dev)
    fmask = freeF_dev[faces_t].reshape(nb_b, bdim).to(torch.float64)
    Ej, LIj, LJj = (torch.as_tensor(a, device=dev) for a in (E, LI, LJ))
    eye = torch.eye(bdim, dtype=torch.float64, device=dev)
    chunk = max(1, int(chunk_bytes / max(1, fsz * fsz * nfb * nfb * 8)))
    outs = []
    for c0 in range(0, nb_b, chunk):
        c1 = min(nb_b, c0 + chunk)
        blk = (S5p[Ej[0, c0:c1], LIj[0, c0:c1], :, LJj[0, c0:c1], :]
               + S5p[Ej[1, c0:c1], LIj[1, c0:c1], :, LJj[1, c0:c1], :])
        blk = blk.permute(0, 1, 3, 2, 4).reshape(-1, bdim, bdim)
        fm = fmask[c0:c1]
        blk = blk * (fm[:, :, None] * fm[:, None, :])
        blk = blk + eye[None] * (1.0 - fm)[:, None, :]
        outs.append(torch.linalg.inv(blk))
    return torch.cat(outs)


def face_star_smoother(layout: FaceBlockLayout, S_skel_perm, free_mask,
                       dtype=torch.float32) -> FaceStarSmoother:
    """Build a FaceStarSmoother from face-major skeleton element blocks
    ``S_skel_perm`` (ne, 4nfb, 4nfb) and the (n,) full-space free mask."""
    lay = layout
    free = np.asarray(free_mask)
    freeF = np.concatenate(
        [
            free[: lay.off_c].reshape(lay.nface, lay.nfd_v),
            free[lay.nhd:].reshape(lay.nface, lay.nfd_f),
        ],
        axis=1,
    )
    return FaceStarSmoother(lay, S_skel_perm, _edge_star_faces(lay.mesh),
                            freeF, dtype)


def _edge_star_faces(mesh) -> list[np.ndarray]:
    """edge id -> sorted array of face ids containing that edge."""
    faces = np.asarray(mesh.faces)
    edge_key = {tuple(e): i for i, e in enumerate(mesh.edges.tolist())}
    out: list[list[int]] = [[] for _ in range(mesh.nedge)]
    for f, (a, b, c) in enumerate(faces.tolist()):
        for pair in ((a, b), (a, c), (b, c)):
            out[edge_key[pair]].append(f)
    return [np.asarray(sorted(s), np.int64) for s in out]

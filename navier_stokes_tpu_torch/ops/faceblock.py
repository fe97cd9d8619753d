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

``split_k`` > 1 (bench.py's ``NSTPU_SPLITK``) streams the element tables
of the f32 A apply and of the compensated A, B, BT applies through the
split-k kernels over ``split_k`` consecutive-tile sub-tables
(:func:`~navier_stokes_tpu_torch.ops.block_mv.pack_splitk`); B32/BT32 stay
on :func:`block_mv2`, as the JAX package keeps them off split-k.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from .block_mv import (
    TILE,
    TILE_COMP,
    block_mv,
    block_mv2,
    block_mv2_splitk,
    block_mv_comp,
    block_mv_comp_splitk,
    block_mv_ds,
    make_segment_apply,
    make_table_apply,
    pack_splitk,
    split_f64,
)
from .local_mv import batched_local_matvec

__all__ = ["FaceBlockLayout", "FaceStarSmoother", "ColorGroup",
           "face_star_smoother", "symmetric_part"]


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

    @cached_property
    def eldofs_fb(self) -> np.ndarray:
        """(ne, 4*nfb) skeleton element dofs in FACE-BLOCK numbering
        (dof = face * nfb + j), face-major order."""
        ef = np.asarray(self.mesh.element_faces).astype(np.int64)
        return (ef[:, :, None] * self.nfb
                + np.arange(self.nfb)[None, None, :]).reshape(self.ne, -1)

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

    def elem_apply(self, A_perm, use_kernel: bool = False):
        """y = A u from face-major element blocks (ne, nb, nb), f32 or f64.
        The default is a plain einsum (the model's f64 operators of the
        true-residual check, independent of every kernel); ``use_kernel``
        takes the product through :func:`batched_local_matvec` (the
        transient step's operators)."""
        if use_kernel:
            return lambda u: self._elem_io(
                u, lambda ue: batched_local_matvec(A_perm, ue))
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

    def pack_elem_tables(self, mats, split_k: int = 1, tile: int = TILE):
        """Contiguous f32 device copies of (ne, nb, nb) face-major tables,
        shared between :meth:`elem_apply_tiled` and :meth:`elem_apply_comp`
        (one copy of the split hi/lo tables serves both phases).  With
        ``split_k`` > 1 each table is a list of ``split_k`` sub-tables of
        ``tile``-block tiles (:func:`pack_splitk`)."""
        out = []
        for A in mats:
            if isinstance(A, np.ndarray):
                A = torch.from_numpy(np.ascontiguousarray(A))
            A = A.to(device=self.device, dtype=torch.float32).contiguous()
            out.append(pack_splitk(A, split_k, tile) if split_k > 1 else A)
        return out

    def elem_apply_multi(self, mats_and_scales):
        """y = sum_k c_k * (A_k u) sharing one gather/scatter round trip, in
        the tables' dtype, as the JAX package's einsums: float64 tables
        (numpy or tensor) each through :func:`batched_local_matvec` in
        float64 (kernel 8), any other each through :func:`block_mv` of its
        f32 device copy (kernel 1).  A scale ``c_k`` is None, a Python
        float or a 0-d tensor (never read on the host)."""
        kinds = {A.dtype in (np.float64, torch.float64)
                 for A, _ in mats_and_scales}
        if len(kinds) != 1:
            raise ValueError("elem_apply_multi: no tables, or float64 "
                             "tables mixed with other dtypes")
        f64 = kinds.pop()
        if f64:
            tabs = [(torch.as_tensor(A, device=self.device).to(
                torch.float64).contiguous(), c) for A, c in mats_and_scales]
            product = batched_local_matvec
        else:
            tabs = [(self.pack_elem_tables([A])[0], c)
                    for A, c in mats_and_scales]
            product = block_mv

        def kernel(ue):
            if f64:
                ue = ue.to(torch.float64)
            ye = None
            for A, c in tabs:
                t = product(A, ue)
                t = t if c is None else c * t
                ye = t if ye is None else ye + t
            return ye

        return lambda u: self._elem_io(u, kernel)

    def elem_apply_tiled(self, tabs, tile: int = TILE):
        """y = (sum_k A_k) u for one f32 device table (:func:`block_mv`) or
        the split hi/lo pair in ONE stream (:func:`block_mv2`); ``tabs``
        from :meth:`pack_elem_tables`.  The pair as sub-table lists goes
        through :func:`block_mv2_splitk` (kernel 6)."""
        tabs = list(tabs)
        split = isinstance(tabs[0], list)
        if len(tabs) == 1 and not split:
            kernel = lambda ue: block_mv(tabs[0], ue)
        elif len(tabs) == 2 and split:
            kernel = lambda ue: block_mv2_splitk(tabs[0], tabs[1], ue, tile)
        elif len(tabs) == 2:
            kernel = lambda ue: block_mv2(tabs[0], tabs[1], ue)
        else:
            raise ValueError("elem_apply_tiled takes one table or a pair "
                             "(split only as a pair)")

        def apply(u):
            return self._elem_io(u.to(torch.float32), kernel)

        apply.tables = tabs
        return apply

    def elem_apply_comp(self, Ah, Al, tile: int = TILE):
        """COMPENSATED double-single apply: y (f64) = (A_hi + A_lo) u (f64)
        through :func:`block_mv_comp` at f32 streaming speed; the f32 device
        tables may be the ones :meth:`elem_apply_tiled` streams.  Sub-table
        lists go through :func:`block_mv_comp_splitk` (kernel 7)."""

        def kernel(ue):
            yh, yl = _comp(Ah, Al, split_f64(ue), tile)
            return yh.to(torch.float64) + yl.to(torch.float64)

        def apply(u):
            return self._elem_io(u, kernel)

        apply.tables = [Ah, Al]
        return apply

    def elem_apply_ds(self, A_hi, A_lo):
        """Plain double-single apply: y (f64) = (A_hi + A_lo) u (f64) as
        the f64 sum of the three f32 products hi*hi, hi*lo, lo*hi, one
        :func:`block_mv_ds` launch over the (ne, nb, nb) f32 device tables.
        Accurate to f32 accumulation noise relative to the input (row
        cancellation floors it near 1e-6); :meth:`elem_apply_comp` is the
        compensated companion the solve uses."""

        def apply(u):
            return self._elem_io(u, lambda ue: _ds3(A_hi, A_lo, ue))

        apply.tables = [A_hi, A_lo]
        return apply

    def rect_apply_ds(self, B_hi, B_lo, eldofs_p):
        """Plain double-single (B, BT) for the pressure coupling: f64 in and
        out through one :func:`block_mv_ds` launch each (see
        :meth:`elem_apply_ds`); BT streams transposed copies made here."""
        m = B_hi.shape[1]
        _check_contiguous_rows(eldofs_p, self.ne, m)
        T_hi = B_hi.transpose(1, 2).contiguous()
        T_lo = B_lo.transpose(1, 2).contiguous()

        def B(u):
            uF, ui = self.split(u)
            return _ds3(B_hi, B_lo, self.gather_elem(uF, ui)).reshape(-1)

        def BT(p):
            ye = _ds3(T_hi, T_lo, p.reshape(self.ne, m))
            yF, yi = self.scatter_elem(ye)
            return self.join(yF, yi)

        B.tables, BT.tables = [B_hi, B_lo], [T_hi, T_lo]
        return B, BT

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

    def rect_apply_comp(self, fh, fl, eldofs_p, split_k: int = 1,
                        tile: int = TILE_COMP):
        """Compensated (B, BT) for the pressure coupling (f64 in and out)
        from f32 device tables (ne, m, nb) through :func:`block_mv_comp`;
        BT streams transposed copies.  With ``split_k`` > 1 all four go
        through :func:`block_mv_comp_splitk` over sub-tables of
        ``tile``-block tiles."""
        m = fh.shape[1]
        _check_contiguous_rows(eldofs_p, self.ne, m)
        th, tl = fh.transpose(1, 2).contiguous(), fl.transpose(1, 2).contiguous()
        if split_k > 1:
            fh, fl, th, tl = (pack_splitk(t, split_k, tile)
                              for t in (fh, fl, th, tl))

        def comp(hi, lo, x):
            yh, yl = _comp(hi, lo, split_f64(x), tile)
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


def _ds3(hi, lo, x):
    """f64 sum of the three f32 products of :func:`block_mv_ds`."""
    f64 = torch.float64
    hh, hl, lh = block_mv_ds(hi, lo, *split_f64(x))
    return hh.to(f64) + hl.to(f64) + lh.to(f64)


def _comp(hi, lo, x_pair, tile):
    """The compensated kernel on one table pair or on sub-table lists."""
    if isinstance(hi, list):
        return block_mv_comp_splitk(hi, lo, *x_pair, tile)
    return block_mv_comp(hi, lo, *x_pair)


# ----------------------------------------------------------------------
# Face-granular overlapping block smoother (edge-star patches)
# ----------------------------------------------------------------------


class FaceStarSmoother:
    """Overlapping block smoother over FACE-granular patches (the
    edge-stars: the faces around each mesh edge), every index op a
    block-row gather of slice nfb: additive block-Jacobi
    (:meth:`build_additive`, :meth:`smooth_faces`) and the row-panel
    multicolor block-GS color steps (:meth:`color_row_groups`,
    :meth:`solve_color_rows`).

    The constructor builds the topology only.  Blocks are bucketed by face
    count; ``block_faces`` lists every block's faces in bucket order -- the
    order the GS coloring sees, as in the JAX package.  The scatter back is
    the transpose-gather: every face belongs to exactly THREE edge-stars.

    The f64 setup tables -- the face-major skeleton table
    (:meth:`skeleton_table`) and the bucket inverses
    (:meth:`bucket_inverses`) -- are passed to the mode's build method and not
    kept: the smoother holds only the tables its applies stream.
    ``compute_dtype`` is the arithmetic of every table apply (f64: the plain
    batched products of :func:`~navier_stokes_tpu_torch.ops.block_mv.
    make_table_apply`)."""

    def __init__(self, layout: FaceBlockLayout, edge_faces,
                 freeF: np.ndarray, compute_dtype=torch.float32):
        nface = layout.nface
        dev = layout.device
        self.layout = layout
        self.compute_dtype = compute_dtype
        self.freeF_np = np.asarray(freeF)
        self.freeF = torch.as_tensor(freeF, device=dev)

        sizes = np.array([len(f) for f in edge_faces])
        order = np.argsort(sizes, kind="stable")
        self.pos_np = layout.pos.cpu().numpy()  # topology only
        pos3 = np.full((nface, 3), -1, np.int64)
        cnt = np.zeros(nface, np.int32)
        self.faces_np = []  # (nb_b, fsz) face ids per bucket
        slot_base = 0
        for fsz in np.unique(sizes):
            sel = order[sizes[order] == fsz]
            faces_b = np.stack([np.asarray(edge_faces[i]) for i in sel])
            for b, i in enumerate(sel):
                for k, f in enumerate(edge_faces[i]):
                    pos3[f, cnt[f]] = slot_base + b * fsz + k
                    cnt[f] += 1
            self.faces_np.append(faces_b)
            slot_base += len(sel) * fsz
        assert cnt.max() <= 3
        pos3 = np.where(pos3 < 0, slot_base, pos3)  # pad -> zero row
        self.pos3 = torch.as_tensor(pos3, device=dev)
        self.buckets = []  # (faces_b tensor, table apply): additive mode

    @property
    def block_faces(self) -> list[np.ndarray]:
        """Every block's faces, in bucket order."""
        return [row for faces_b in self.faces_np for row in faces_b]

    def skeleton_table(self, S_perm) -> torch.Tensor:
        """The f64 face-major skeleton table (ne+1, 4, nfb, 4, nfb) on the
        device: ``S_perm`` (ne, 4nfb, 4nfb) plus one zero element (index
        ne), the source of the block inverses and the GS row panels."""
        lay = self.layout
        S = torch.as_tensor(np.asarray(S_perm), dtype=torch.float64,
                            device=lay.device)
        return torch.cat([S.reshape(lay.ne, 4, lay.nfb, 4, lay.nfb),
                          S.new_zeros((1, 4, lay.nfb, 4, lay.nfb))])

    def bucket_inverses(self, S5p, symmetrize: bool = True) -> list:
        """Per bucket, the f64 inverses of its edge-star blocks of S5p.

        Constrained (Dirichlet) dofs are decoupled by zeroing their block
        rows/columns and placing 1 on the diagonal before inversion
        (``torch.linalg.inv``).  ``symmetrize``: average each inverse with
        its transpose -- the blocks are symmetric, and so then are the
        stored (rounded) inverses, which keeps the GS sweep an exactly
        symmetric operator.  The JAX package does not; ``False`` gives its
        tables."""
        lay = self.layout
        return [_bucket_inverses(S5p, faces_b, self.pos_np, self.freeF,
                                 lay.nfb, lay.ne, symmetrize)
                for faces_b in self.faces_np]

    def build_additive(self, invs, dtype=torch.float32, split_k: int = 1):
        """Additive mode: one table apply per bucket of the inverses
        ``invs`` (:meth:`bucket_inverses`), stored in ``dtype`` and split
        ``split_k`` ways."""
        dev = self.layout.device
        self.buckets = [
            (torch.as_tensor(faces_b, device=dev),
             make_table_apply(inv, store_dtype=dtype, split_k=split_k,
                              compute_dtype=self.compute_dtype))
            for faces_b, inv in zip(self.faces_np, invs)]

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

    # -- row-panel multicolor GS ---------------------------------------------

    def color_row_groups(self, colors: np.ndarray, S5p, invs,
                         panel_dtype=torch.float32, inv_dtype=torch.float32):
        """Per-color groups for :meth:`solve_color_rows` that compute the
        color's residual from ROW PANELS of S instead of a full skeleton
        apply (the host-table path of the JAX package's
        ``color_row_groups``).

        A face belongs to exactly 3 edge-stars, all of different colors, so
        computing the residual at just the color's faces streams each
        face's row panel 3 times per sweep direction: 3 full-S streams per
        direction, whatever the color count.  Per color:

        * panels (nsel+1, nfb, 2*n_skel) in ``panel_dtype``: for each member
          face, the rows of S_e at the face's slot in each of its <= 2
          adjacent elements, free-masked in rows and columns; one trailing
          zero block;
        * the solve table in ``inv_dtype``: the color's edge-star inverses
          stored by segment, one segment per bucket (its ``nkeep`` blocks of
          d = fsz * nfb, without padding), standing for the JAX package's
          merged padded table (nblk_c+1, bmax, bmax) -- each inverse
          zero-padded to the color's largest block (bmax = fsz_max * nfb),
          one trailing zero block -- whose layout its input and output keep
          (:func:`~navier_stokes_tpu_torch.ops.block_mv.block_mv_segments`:
          one launch per color, streaming only the real blocks).

        ``colors``: (nblocks,) in bucket order (``block_faces``); ``S5p``
        and ``invs``: the f64 setup tables (:meth:`skeleton_table`,
        :meth:`bucket_inverses`)."""
        lay = self.layout
        nfb, nface, ne, n_skel = lay.nfb, lay.nface, lay.ne, lay.n_skel
        dev = lay.device
        efaces = np.asarray(lay.mesh.element_faces).astype(np.int64)
        efaces_pad = np.concatenate([efaces, np.full((1, 4), nface)])
        # element-skeleton column mask: free dofs of e's 4 faces (+ pad)
        colmask = np.concatenate([self.freeF_np[efaces].reshape(ne, n_skel),
                                  np.zeros((1, n_skel), bool)])
        freeP = np.concatenate([self.freeF_np, np.zeros((1, nfb), bool)])
        S_ext = S5p.reshape(ne + 1, n_skel, n_skel)
        base = np.cumsum([0] + [len(f) for f in self.faces_np])
        groups = []
        for c in range(int(np.max(colors)) + 1):
            parts_meta = []  # (ofs, nkeep, fsz, bucket_idx, keep)
            faces_list = []
            ofs = 0
            for bi, faces_b in enumerate(self.faces_np):
                keep = np.where(colors[base[bi]: base[bi + 1]] == c)[0]
                if not len(keep):
                    continue
                fb = faces_b[keep]
                faces_list.append(fb.ravel())
                parts_meta.append((ofs, len(keep), fb.shape[1], bi, keep))
                ofs += fb.size
            faces_c = np.concatenate(faces_list)
            nsel = len(faces_c)
            assert len(np.unique(faces_c)) == nsel, \
                "same-color blocks share a face"
            fsz_max, nblk_c, gpos, pos1 = _merged_color_plan(
                parts_meta, self.faces_np, nface, nsel)
            inv_segs = [invs[bi][torch.as_tensor(keep, device=dev)]
                        for (_ofs, _nkeep, _fsz, bi, keep) in parts_meta]
            # row panels at faces_c from each adjacent element (pad: the
            # zero element ne), columns then rows free-masked
            p2 = self.pos_np[faces_c]  # (nsel, 2) elem*4+lf, pad ne*4
            el2, lf2 = p2 // 4, p2 % 4
            rows = lf2[:, :, None] * nfb + np.arange(nfb)  # (nsel, 2, nfb)
            el2_t = torch.as_tensor(el2, device=dev)
            pan = S_ext[el2_t[:, :, None], torch.as_tensor(rows, device=dev)]
            mask = (colmask[el2][:, :, None, :]
                    & self.freeF_np[faces_c][:, None, :, None])
            pan = pan * torch.as_tensor(mask, device=dev)
            panels = torch.cat([
                pan.permute(0, 2, 1, 3).reshape(nsel, nfb, 2 * n_skel),
                pan.new_zeros((1, nfb, 2 * n_skel))])
            fc = np.concatenate([faces_c, [nface]])
            idx8 = efaces_pad[np.concatenate([el2, [[ne, ne]]])]
            groups.append(ColorGroup(
                faces=torch.as_tensor(fc, device=dev),
                free=torch.as_tensor(freeP[fc], device=dev),
                elem_faces=torch.as_tensor(idx8.reshape(nsel + 1, 8),
                                           device=dev),
                panels=make_table_apply(panels, store_dtype=panel_dtype,
                                        compute_dtype=self.compute_dtype),
                rows=torch.as_tensor(np.concatenate(
                    [gpos, np.full((1, fsz_max), nsel)]), device=dev),
                solve=make_segment_apply(inv_segs, nblk_c + 1,
                                         fsz_max * nfb, inv_dtype, dev,
                                         self.compute_dtype),
                slot=torch.as_tensor(np.concatenate(
                    [pos1, [nblk_c * fsz_max]]), device=dev),
            ))
        return groups

    def solve_color_rows(self, g: "ColorGroup", xP, yP=None):
        """One color step of the sweep with the residual from row panels:
        dy = sum_{b in color} P_b S_b^{-1} (x - S y)|_rows(b).

        ``xP``, ``yP``: the face iterate, row-major (nface+1, nfb) with one
        zero pad row; ``yP=None`` is the zero iterate (the first forward
        color).  The input is free-masked here, at entry.  Returns the
        update in the same layout, its pad row zero."""
        nfb = self.layout.nfb
        rc = torch.where(g.free, xP[g.faces], 0.0)  # (nsel+1, nfb)
        if yP is not None:
            ye = yP[g.elem_faces].reshape(-1, 8 * nfb)
            rc = rc - g.panels(ye)
        yb = g.solve(rc[g.rows].reshape(g.rows.shape[0], -1))
        return yb.reshape(-1, nfb)[g.slot]


@dataclass
class ColorGroup:
    """One color of the row-panel GS sweep (index plans on the device):

    * ``faces`` (nsel+1,): the color's faces, then the pad row nface;
    * ``free`` (nsel+1, nfb): their free mask (pad row False);
    * ``elem_faces`` (nsel+1, 8): the 4 faces of each adjacent element (pad
      element -> the pad row);
    * ``panels``: table apply of the row panels (nsel+1, nfb, 2*n_skel);
    * ``rows`` (nblk_c+1, fsz_max): residual rows of each block (pad -> the
      zero row nsel);
    * ``solve``: segment apply of the inverses, (nblk_c+1, bmax) in and
      out (``solve.table``: the
      :class:`~navier_stokes_tpu_torch.ops.block_mv.SegmentTable`);
    * ``slot`` (nface+1,): face -> row of the solve output (pad -> a row of
      the zero block)."""

    faces: torch.Tensor
    free: torch.Tensor
    elem_faces: torch.Tensor
    panels: object
    rows: torch.Tensor
    solve: object
    slot: torch.Tensor


def edge_star_block_plan(faces_b, pos_np, ne: int):
    """Index plans (E, LI, LJ), each (2, nb_b, fsz, fsz), that gather one
    bucket's edge-star blocks from the face-major skeleton table S5p (ne
    elements plus one zero element, index ne): block (i, j) is
    S5p[E[0], LI[0], :, LJ[0], :] + S5p[E[1], LI[1], :, LJ[1], :].

    Diagonal face blocks sum the face's (up to) two adjacent elements;
    off-diagonal blocks come from the one element shared by faces i and j
    (two distinct tets share at most one face), the second term the zero
    element.  Topology only (host numpy)."""
    nb_b, fsz = faces_b.shape
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
    return E, LI, LJ


def _bucket_inverses(S5p, faces_b, pos_np, freeF_dev, nfb, ne,
                     symmetrize: bool, chunk_bytes: float = 2.5e8):
    """One bucket's edge-star blocks, gathered from the face-major skeleton
    table (plus one zero element, :func:`edge_star_block_plan`) and
    inverted in f64."""
    nb_b, fsz = faces_b.shape
    bdim = fsz * nfb
    E, LI, LJ = edge_star_block_plan(faces_b, pos_np, ne)
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
        inv = torch.linalg.inv(blk)
        outs.append(symmetric_part(inv) if symmetrize else inv)
    return torch.cat(outs)


def _merged_color_plan(parts_meta, faces_by_bucket, nface, nsel):
    """Host index plans for one color's MERGED padded block solve.

    ``parts_meta``: [(ofs, nkeep, fsz, bucket_idx, keep)] in color-row
    order.  Returns (fsz_max, nblk_c, gpos, pos1): ``gpos`` (nblk_c,
    fsz_max) row indices into the color's residual rows (pad -> nsel, a
    zero row), ``pos1`` (nface,) face -> slot in the (nblk_c*fsz_max, nfb)
    padded result (pad -> nblk_c*fsz_max, a zero row)."""
    fsz_max = max(p[2] for p in parts_meta)
    nblk_c = sum(p[1] for p in parts_meta)
    gpos = np.full((nblk_c, fsz_max), nsel, np.int64)
    pos1 = np.full(nface, -1, np.int64)
    blk = 0
    for (ofs, nkeep, fsz, bi, keep) in parts_meta:
        rows = ofs + np.arange(nkeep * fsz).reshape(nkeep, fsz)
        gpos[blk: blk + nkeep, :fsz] = rows
        fb = faces_by_bucket[bi][keep]
        pos1[fb] = ((blk + np.arange(nkeep))[:, None] * fsz_max
                    + np.arange(fsz)[None, :])
        blk += nkeep
    pos1 = np.where(pos1 < 0, nblk_c * fsz_max, pos1)
    return fsz_max, nblk_c, gpos, pos1


def symmetric_part(A):
    """(A + A^T) / 2 over the last two axes (numpy array or tensor)."""
    return 0.5 * (A + A.swapaxes(-1, -2))


def face_star_smoother(layout: FaceBlockLayout, free_mask,
                       compute_dtype=torch.float32) -> FaceStarSmoother:
    """The edge-star smoother's topology for ``layout`` and the (n,)
    full-space free mask; ``compute_dtype`` is the arithmetic of every
    table apply (f64 on the CPU only)."""
    lay = layout
    free = np.asarray(free_mask)
    freeF = np.concatenate(
        [
            free[: lay.off_c].reshape(lay.nface, lay.nfd_v),
            free[lay.nhd:].reshape(lay.nface, lay.nfd_f),
        ],
        axis=1,
    )
    return FaceStarSmoother(lay, _edge_star_faces(lay.mesh), freeF,
                            compute_dtype)


def _edge_star_faces(mesh) -> list[np.ndarray]:
    """edge id -> sorted array of face ids containing that edge."""
    faces = np.asarray(mesh.faces)
    edge_key = {tuple(e): i for i, e in enumerate(mesh.edges.tolist())}
    out: list[list[int]] = [[] for _ in range(mesh.nedge)]
    for f, (a, b, c) in enumerate(faces.tolist()):
        for pair in ((a, b), (a, c), (b, c)):
            out[edge_key[pair]].append(f)
    return [np.asarray(sorted(s), np.int64) for s in out]

"""Face-sharded production solver: the split-f32 path of the flagship solve
on ``torch.distributed``.

Counterpart of ``navier_stokes_tpu/parallel/faceshard.py``, which shards
the production algorithm (Jacobi-equilibrated split-f32 operators with
scatter-free face-block applies, the skeleton edge-star smoother or
multicolor GS sweep with the vector-P1 aux-space coarse correction, MINRES
refinement passes) under ``shard_map``.  The unit of distribution is the
face-major layout of ``ops/faceblock.py``:

* elements are partitioned in contiguous index blocks (thin slabs);
* a FACE is owned by the lowest rank among its <= 2 adjacent elements, so
  each rank's face rows form a padded (npad_f, nfb) matrix, and element
  interiors go with their elements;
* halo exchange moves whole face rows: pack the owned rows other ranks
  touch, one ``all_gather``, local products over the rank's face-major
  element blocks, and a second packed ``all_gather`` returning foreign-face
  contributions to their owners;
* the aux-space coarse correction reduces the P1 vertex residual with one
  ``all_reduce`` and solves it REPLICATED on every rank.

A velocity is each rank's block [own face rows | own element interiors]
of the flat layout (``FaceShardPlan.nloc`` entries), a pressure the rank's
(ne_max * m) block -- the same blocks and padding as the JAX package's flat
vector, so ``FaceShardPlan.vel_to_sharded`` / ``vel_to_global`` map the
same slots.  The refinement drivers run on them unchanged, their inner
products summed over the ranks (``group``).

The work splits in two:

* :func:`shard_fast_tables` -- host numpy, the JAX package's setup
  (equilibration, split hi/lo blocks, skeleton tables, the smoother's
  need/produce sets, the plan) returning the plan and EVERY rank's tables,
  bitwise equal to the ones the JAX package puts on its devices;
* :func:`rank_fast_ops` -- one rank moves its own tables to its device
  (fresh allocations: the kernels' bulk copies need 16-byte aligned
  tables) and builds its operators: the split A pair through kernel 2
  (``block_mv2``), B and B^T likewise, every preconditioner table
  (extension, interior solve, coarse transfer, S, edge-star inverses, GS
  row panels, each GS color's solves as one segment table) through kernel
  1 (``block_mv``, ``block_mv_segments``), the f64 residual A through
  kernel 8 (``batched_local_matvec``); the f64 pressure coupling stays a
  plain product, as the model's own f64 B is.

:func:`build_sharded_fast_ops` and :func:`sharded_fast_flagship_solve`
keep the JAX package's names and results.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.assembly import ScatterPlan
from ..ops.block_mv import block_mv, block_mv2, make_segment_apply
from ..ops.local_mv import batched_local_matvec
from .ddshard import block_element_partition
from .sharding import COLLECTIVES, DeviceMesh, Ranks, fresh_table

__all__ = ["FaceShardPlan", "FastShardTables", "shard_fast_tables",
           "rank_fast_ops", "build_sharded_fast_ops", "fast_refinement",
           "fast_ops_rank", "fast_solve_rank", "sharded_fast_flagship_solve"]


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _pad_rows_2d(rows: list[np.ndarray], fill, width=None, dtype=np.int64):
    m = width if width is not None else max(
        (len(r) for r in rows), default=0)
    m = max(m, 1)
    out = np.full((len(rows), m), fill, dtype=dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


class FaceShardPlan:
    """Host-side partition + halo-exchange plan for a FaceBlockLayout.

    ``need_extra_faces`` / ``produce_extra_faces``: per-shard global faces
    a shard must additionally see in its halo / write contributions to,
    beyond its own elements' faces (the faces of smoother blocks assigned
    to it)."""

    def __init__(self, lay, n_shards: int,
                 need_extra_faces: list[set] | None = None,
                 produce_extra_faces: list[set] | None = None):
        self.lay = lay
        self.n_shards = n_shards
        ne, nface = lay.ne, lay.nface
        pos = _np(lay.pos)  # face -> <=2 (elem*4+lf), pad = ne*4
        efaces = _np(lay.efaces)

        es = block_element_partition(ne, n_shards)
        self.elem_shard = es
        # face owner: lowest shard among adjacent elements
        e0 = np.where(pos[:, 0] < ne * 4, pos[:, 0] // 4, 0)
        e1 = np.where(pos[:, 1] < ne * 4, pos[:, 1] // 4, ne - 1)
        fowner = np.minimum(es[e0], np.where(pos[:, 1] < ne * 4,
                                             es[e1], n_shards))
        self.fowner = fowner

        self.own_faces = [np.where(fowner == s)[0] for s in range(n_shards)]
        self.npad_f = max(max((len(o) for o in self.own_faces), default=1), 1)
        slot_f = np.zeros(nface, np.int64)
        for s in range(n_shards):
            slot_f[self.own_faces[s]] = np.arange(len(self.own_faces[s]))
        self.slot_f = slot_f

        self.els_of = [np.where(es == s)[0] for s in range(n_shards)]
        self.ne_max = max(max((len(e) for e in self.els_of), default=1), 1)

        # need set: faces of my elements (+ extras); halo = need \ own
        need = []
        for s in range(n_shards):
            nf = set(np.unique(efaces[self.els_of[s]]).tolist())
            if need_extra_faces is not None:
                nf |= need_extra_faces[s]
            need.append(nf)
        self.halo_faces = [
            np.asarray(sorted(f for f in need[s] if fowner[f] != s),
                       np.int64)
            for s in range(n_shards)
        ]
        self.n_halo_max = max(
            max((len(h) for h in self.halo_faces), default=1), 1)
        halo_pos = [
            {int(f): i for i, f in enumerate(self.halo_faces[s])}
            for s in range(n_shards)
        ]
        self.halo_pos = halo_pos

        # forward packing: own faces of s that appear in anyone's halo
        pack = [[] for _ in range(n_shards)]
        pack_pos = [dict() for _ in range(n_shards)]
        for s in range(n_shards):
            for f in self.halo_faces[s]:
                o = int(fowner[f])
                if int(f) not in pack_pos[o]:
                    pack_pos[o][int(f)] = len(pack[o])
                    pack[o].append(int(f))
        self.Bmax = max(max((len(p) for p in pack), default=1), 1)
        self.pack_slots = _pad_rows_2d(
            [slot_f[np.asarray(p, np.int64)] if p else np.zeros(0, np.int64)
             for p in pack], fill=0, width=self.Bmax)
        self.pack_mask = _pad_rows_2d(
            [np.ones(len(p), np.int64) for p in pack], fill=0,
            width=self.Bmax)
        # halo fetch positions in the gathered (n_shards*Bmax) row buffer
        self.halo_src = _pad_rows_2d(
            [np.asarray(
                [int(fowner[f]) * self.Bmax + pack_pos[int(fowner[f])][int(f)]
                 for f in self.halo_faces[s]], np.int64)
             for s in range(n_shards)], fill=0, width=self.n_halo_max)
        self.halo_mask = _pad_rows_2d(
            [np.ones(len(h), np.int64) for h in self.halo_faces],
            fill=0, width=self.n_halo_max)

        # produce set: foreign faces my elements (or extras) write to
        prod = []
        for s in range(n_shards):
            pf = set(np.unique(efaces[self.els_of[s]]).tolist())
            if produce_extra_faces is not None:
                pf |= produce_extra_faces[s]
            prod.append(sorted(int(f) for f in pf if fowner[f] != s))
        self.prod_faces = [np.asarray(p, np.int64) for p in prod]
        self.n_prod_pad = max(
            max((len(p) for p in prod), default=1), 1)
        prod_pos = [
            {int(f): i for i, f in enumerate(prod[s])}
            for s in range(n_shards)
        ]
        self.prod_pos = prod_pos
        # reverse fold: where in the gathered (n_shards*n_prod_pad) buffer
        # live rows destined to shard t, and at which own slot they land
        rev_src, rev_dst = [], []
        for t in range(n_shards):
            src, dst = [], []
            for s in range(n_shards):
                for i, f in enumerate(prod[s]):
                    if int(fowner[f]) == t:
                        src.append(s * self.n_prod_pad + i)
                        dst.append(int(slot_f[f]))
            rev_src.append(np.asarray(src, np.int64))
            rev_dst.append(np.asarray(dst, np.int64))
        wid = max(max((len(r) for r in rev_src), default=1), 1)
        self.rev_src = _pad_rows_2d(rev_src, fill=0, width=wid)
        self.rev_dst = _pad_rows_2d(rev_dst, fill=0, width=wid)
        self.rev_mask = _pad_rows_2d(
            [np.ones(len(r), np.int64) for r in rev_src], fill=0, width=wid)

        # local face id: own face -> slot, halo face -> npad_f + halo pos,
        # anything else -> zero row (npad_f + n_halo_max)
        self.zero_row = self.npad_f + self.n_halo_max
        loc_id = np.full((n_shards, nface), self.zero_row, np.int64)
        for s in range(n_shards):
            loc_id[s, self.own_faces[s]] = slot_f[self.own_faces[s]]
            if len(self.halo_faces[s]):
                loc_id[s, self.halo_faces[s]] = (
                    self.npad_f + np.arange(len(self.halo_faces[s]))
                )
        self.loc_id = loc_id

        # per-shard element-face tables in local ids, padded elements -> 0
        efl = np.zeros((n_shards, self.ne_max, 4), np.int64)
        for s in range(n_shards):
            sel = self.els_of[s]
            efl[s, : len(sel)] = loc_id[s][efaces[sel]]
        self.efaces_loc = efl

        # sibling-assembly plan: for [own | produce] faces of shard s, the
        # <=2 (local elem*4+lf) slots OF THIS SHARD feeding the face (a
        # foreign sibling's contribution is folded by its own shard);
        # pad -> ne_max*4 (a zero row)
        pos2 = np.full(
            (n_shards, self.npad_f + self.n_prod_pad, 2),
            self.ne_max * 4, np.int64,
        )
        eloc = np.full((n_shards, ne), -1, np.int64)
        for s in range(n_shards):
            eloc[s, self.els_of[s]] = np.arange(len(self.els_of[s]))
        for s in range(n_shards):
            targets = np.concatenate(
                [self.own_faces[s], self.prod_faces[s]]).astype(np.int64)
            rows = np.concatenate([
                np.arange(len(self.own_faces[s])),
                self.npad_f + np.arange(len(self.prod_faces[s])),
            ])
            for c in range(2):
                slot = pos[targets, c]
                hit = slot < ne * 4
                hit[hit] = es[slot[hit] // 4] == s
                # the first hit fills column 0, a second one column 1
                k = (c == 1) & (pos2[s, rows, 0] != self.ne_max * 4)
                col = np.where(k, 1, 0)
                le = eloc[s, np.where(hit, slot // 4, 0)]
                pos2[s, rows[hit], col[hit]] = le[hit] * 4 + slot[hit] % 4
        self.pos2 = pos2

        # local face id -> row in the [own | produce] output buffer (halo
        # faces a shard writes to are by construction in its produce set);
        # everything else -> a dump row one past the buffer (dropped)
        loc2op = np.full((n_shards, self.zero_row + 1),
                         self.npad_f + self.n_prod_pad, np.int64)
        for s in range(n_shards):
            nown = len(self.own_faces[s])
            loc2op[s, :nown] = np.arange(nown)
            for f in self.halo_faces[s]:
                if int(f) in prod_pos[s]:
                    loc2op[s, loc_id[s][f]] = (
                        self.npad_f + prod_pos[s][int(f)])
        self.loc2op = loc2op

    # -- host-side layout conversions ------------------------------------

    def split_np(self, x: np.ndarray):
        lay = self.lay
        uF = np.concatenate(
            [x[: lay.off_c].reshape(lay.nface, lay.nfd_v),
             x[lay.nhd:].reshape(lay.nface, lay.nfd_f)], axis=1)
        ui = x[lay.off_c: lay.nhd].reshape(lay.ne, lay.n_int)
        return uF, ui

    def join_np(self, uF: np.ndarray, ui: np.ndarray):
        lay = self.lay
        return np.concatenate([
            uF[:, : lay.nfd_v].reshape(-1), ui.reshape(-1),
            uF[:, lay.nfd_v:].reshape(-1),
        ])

    @property
    def nloc(self) -> int:
        return self.npad_f * self.lay.nfb + self.ne_max * self.lay.n_int

    def vel_to_sharded(self, x: np.ndarray) -> np.ndarray:
        """Global flat velocity (n,) -> sharded flat (n_shards * nloc,)."""
        lay = self.lay
        uF, ui = self.split_np(np.asarray(x))
        out = np.zeros((self.n_shards, self.nloc), np.asarray(x).dtype)
        nF = self.npad_f * lay.nfb
        for s in range(self.n_shards):
            o = self.own_faces[s]
            blk = np.zeros((self.npad_f, lay.nfb), uF.dtype)
            blk[: len(o)] = uF[o]
            out[s, :nF] = blk.reshape(-1)
            e = self.els_of[s]
            bi = np.zeros((self.ne_max, lay.n_int), ui.dtype)
            bi[: len(e)] = ui[e]
            out[s, nF:] = bi.reshape(-1)
        return out.reshape(-1)

    def vel_to_global(self, xs: np.ndarray) -> np.ndarray:
        lay = self.lay
        xs = np.asarray(xs).reshape(self.n_shards, self.nloc)
        nF = self.npad_f * lay.nfb
        uF = np.zeros((lay.nface, lay.nfb), xs.dtype)
        ui = np.zeros((lay.ne, lay.n_int), xs.dtype)
        for s in range(self.n_shards):
            o = self.own_faces[s]
            uF[o] = xs[s, :nF].reshape(self.npad_f, lay.nfb)[: len(o)]
            e = self.els_of[s]
            ui[e] = xs[s, nF:].reshape(self.ne_max, lay.n_int)[: len(e)]
        return self.join_np(uF, ui)

    def p_to_sharded(self, p: np.ndarray, m: int, fill=0.0) -> np.ndarray:
        pe = np.asarray(p).reshape(self.lay.ne, m)
        out = np.full((self.n_shards, self.ne_max, m), fill, pe.dtype)
        for s in range(self.n_shards):
            e = self.els_of[s]
            out[s, : len(e)] = pe[e]
        return out.reshape(-1)

    def p_to_global(self, ps: np.ndarray, m: int) -> np.ndarray:
        ps = np.asarray(ps).reshape(self.n_shards, self.ne_max, m)
        out = np.zeros((self.lay.ne, m), ps.dtype)
        for s in range(self.n_shards):
            e = self.els_of[s]
            out[e] = ps[s, : len(e)]
        return out.reshape(-1)

    def faces_to_sharded(self, xF: np.ndarray, fill=0) -> np.ndarray:
        """(nface, k...) face-row data -> (n_shards, npad_f, k...)."""
        out = np.full((self.n_shards, self.npad_f) + xF.shape[1:], fill,
                      xF.dtype)
        for s in range(self.n_shards):
            o = self.own_faces[s]
            out[s, : len(o)] = xF[o]
        return out

    def elems_to_sharded(self, xe: np.ndarray, fill=0.0) -> np.ndarray:
        """(ne, k...) element data -> (n_shards, ne_max, k...)."""
        out = np.full((self.n_shards, self.ne_max) + xe.shape[1:], fill,
                      xe.dtype)
        for s in range(self.n_shards):
            e = self.els_of[s]
            out[s, : len(e)] = xe[e]
        return out

    def exchange_tables(self) -> dict:
        return dict(
            pack_slots=self.pack_slots, pack_mask=self.pack_mask,
            halo_src=self.halo_src, halo_mask=self.halo_mask,
            rev_src=self.rev_src, rev_dst=self.rev_dst,
            rev_mask=self.rev_mask, efaces_loc=self.efaces_loc,
            pos2=self.pos2, loc2op=self.loc2op,
        )


def _bucket_inverses_np(S_perm, faces_b, pos, freeF, nfb, ne,
                        symmetrize: bool):
    """One bucket's edge-star blocks of the face-level S, each entry the
    (at most two) element contributions of the JAX package's assembled CSR
    (``ops/faceblock.edge_star_block_plan``), constrained dofs decoupled
    (zero rows / columns, 1 on the diagonal), inverted by
    ``np.linalg.inv`` in f64 as the JAX package's host path does
    (``ops/faceblock.FaceStarSmoother``)."""
    from ..ops.faceblock import edge_star_block_plan, symmetric_part

    nb_b, fsz = faces_b.shape
    bdim = fsz * nfb
    E, LI, LJ = edge_star_block_plan(faces_b, pos, ne)
    S5p = np.concatenate([S_perm.reshape(ne, 4, nfb, 4, nfb),
                          np.zeros((1, 4, nfb, 4, nfb))])
    blk = (S5p[E[0], LI[0], :, LJ[0], :] + S5p[E[1], LI[1], :, LJ[1], :])
    blk = blk.transpose(0, 1, 3, 2, 4).reshape(nb_b, bdim, bdim)
    fm = freeF[faces_b].reshape(nb_b, bdim)
    blk = np.where(fm[:, :, None] & fm[:, None, :], blk, 0.0)
    bi, di = np.nonzero(~fm)
    blk[bi, di, di] = 1.0
    inv = np.linalg.inv(blk)
    return symmetric_part(inv) if symmetrize else inv


class FastShardTables:
    """Every rank's host tables of the face-sharded solve
    (:func:`shard_fast_tables`).

    ``plan``: the :class:`FaceShardPlan`; ``tables``: name -> numpy array
    with a leading shard axis, in the order and with the values the JAX
    package puts on its devices (``buckets``: per bucket a dict of
    ``inv``, ``floc``, ``mask``; ``colors``: per color, per part, a dict
    of ``inv``, ``floc``, ``mask``, ``P2``, ``ef2``), plus ``f`` / ``g``,
    the sharded right-hand side; ``common``: what every rank shares (sizes,
    the mesh and boundary of the coarse space, the storage dtypes);
    ``seconds``: host seconds by part."""

    def __init__(self, plan, tables, common, seconds):
        self.plan, self.tables = plan, tables
        self.common, self.seconds = common, seconds

    def rank(self, s: int) -> dict:
        """Shard ``s``'s tables (views, numpy)."""
        def pick(v):
            if isinstance(v, np.ndarray):
                return v[s]
            if isinstance(v, dict):
                return {k: pick(x) for k, x in v.items()}
            return [pick(x) for x in v]

        return pick(self.tables)


def shard_fast_tables(m, n_shards: int, gs: bool = False,
                      symmetrize: bool = False,
                      ext_dtype=torch.float32, inv_dtype=torch.float32,
                      coarse_target: float = 0.9) -> FastShardTables:
    """Host setup of the face-sharded production operators of the 3D MCS
    model ``m`` over ``n_shards`` ranks: the JAX package's
    ``build_sharded_fast_ops`` up to its device puts.

    The math is ``equilibrated_f32_ops``': Jacobi-equilibrated split hi/lo
    f32 element blocks in face-major order, the skeleton preconditioner
    (edge-star smoother + damped vector-P1 aux-space coarse on the skeleton
    Schur complement, exact interior solves, harmonic extension).
    ``gs=True`` adds the symmetric multicolor row-panel GS sweep's tables.
    The defaults are the JAX package's sharded tables (f32, as computed,
    coarse target 0.9); ``symmetrize``, ``ext_dtype`` / ``inv_dtype`` (the
    extension and interior tables / the GS color inverses, rounded on the
    device) and ``coarse_target`` select the port's single-device settings
    (``models/auxspace3d.build_skeleton_preconditioner_3d``).  Returns a
    :class:`FastShardTables`."""
    from ..models.auxspace3d import face_transfer_table
    from ..ops.faceblock import face_star_smoother, symmetric_part
    from ..precond.multicolor import color_blocks

    seconds = {}
    t_all = time.perf_counter()
    lay = m.fb
    if lay is None:
        raise ValueError("sharded fast ops need the face-block layout")
    nfb, n_int, n_skel = lay.nfb, lay.n_int, lay.n_skel
    mQ = int(np.asarray(m.Q.element_dofs).shape[1])

    # ---- equilibration + split blocks (equilibrated_f32_ops' host math)
    t0 = time.perf_counter()
    A_loc = m.A_cond_np
    eldofs = np.asarray(m.Xv.element_dofs)
    d = np.zeros(m.n)
    np.add.at(d, eldofs.ravel(), np.einsum("eii->ei", A_loc).ravel())
    free = _np(m.free)
    D = np.ones(m.n)
    D[free] = 1.0 / np.sqrt(np.maximum(np.abs(d[free]), 1e-300))
    De = D[eldofs]
    A_s = A_loc * De[:, :, None] * De[:, None, :]
    A_sp = lay.permute_blocks(A_s)
    A_hi = A_sp.astype(np.float32)
    A_lo = (A_sp - A_hi.astype(np.float64)).astype(np.float32)
    del A_sp
    B_np = np.asarray(m.B_loc_np, np.float64)
    B_sp = (B_np * De[:, None, :])[:, :, lay.perm]
    B_hi = B_sp.astype(np.float32)
    B_lo = (B_sp - B_hi.astype(np.float64)).astype(np.float32)
    seconds["split tables"] = time.perf_counter() - t0

    # ---- skeleton preconditioner host setup
    t0 = time.perf_counter()
    sym = symmetric_part if symmetrize else (lambda a: a)
    nbv = m.Xv.hdiv.n_basis
    n_face_tot = 4 * lay.nfd_v
    loc_int = np.arange(n_face_tot, nbv)
    nfac = lay.nfd_f * 4
    loc_skel = np.concatenate(
        [np.arange(n_face_tot), np.arange(nbv, nbv + nfac)])
    A_ii = A_s[:, loc_int[:, None], loc_int[None, :]]
    A_is = A_s[:, loc_int[:, None], loc_skel[None, :]]
    A_ss = A_s[:, loc_skel[:, None], loc_skel[None, :]]
    del A_s
    A_ii_inv = sym(np.linalg.inv(A_ii))
    AinvAis = np.matmul(A_ii_inv, A_is)
    S_loc = sym(A_ss - np.matmul(A_is.transpose(0, 2, 1), AinvAis))
    S_perm = lay.permute_skel_blocks(S_loc)
    AinvAis_perm = np.ascontiguousarray(AinvAis[:, :, lay.perm_skel])
    del A_ii, A_is, A_ss, S_loc, AinvAis

    fmask = np.asarray(m.Xv.free_mask)
    sm = face_star_smoother(lay, fmask)  # the edge-star topology
    freeF_np = sm.freeF_np
    pos_np = _np(lay.pos)
    bucket_inv = [_bucket_inverses_np(S_perm, fb, pos_np, freeF_np, nfb,
                                      lay.ne, symmetrize)
                  for fb in sm.faces_np]
    M_F, faces_np = face_transfer_table(m.Xv, nfb)
    seconds["skeleton tables"] = time.perf_counter() - t0

    # ---- plan with smoother-extended need/produce sets
    t0 = time.perf_counter()
    es = block_element_partition(lay.ne, n_shards)
    e0 = np.where(pos_np[:, 0] < lay.ne * 4, pos_np[:, 0] // 4, 0)
    e1 = np.where(pos_np[:, 1] < lay.ne * 4, pos_np[:, 1] // 4, lay.ne - 1)
    fowner0 = np.minimum(es[e0], np.where(pos_np[:, 1] < lay.ne * 4,
                                          es[e1], n_shards))
    # blocks in bucket order; a block lives on the owner of its first face
    block_faces = sm.block_faces
    blk_shard = [int(fowner0[np.asarray(bf)[0]]) for bf in block_faces]
    efaces_np = _np(lay.efaces)
    need_extra = [set() for _ in range(n_shards)]
    prod_extra = [set() for _ in range(n_shards)]
    for b, bf in enumerate(block_faces):
        s = blk_shard[b]
        for f in np.asarray(bf).tolist():
            need_extra[s].add(int(f))
            if int(fowner0[f]) != s:
                prod_extra[s].add(int(f))
            if gs:
                # the GS row panels read the iterate at ALL faces of the
                # <=2 elements adjacent to each block face
                for slot in pos_np[f]:
                    if slot < lay.ne * 4:
                        for f2 in efaces_np[slot // 4].tolist():
                            need_extra[s].add(int(f2))
    seconds["block-face loops"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = FaceShardPlan(lay, n_shards, need_extra, prod_extra)
    if not np.array_equal(plan.fowner, fowner0):
        raise AssertionError("face owners differ from the blocks' owners")
    seconds["plan"] = time.perf_counter() - t0

    # ---- the sharded tables, in the JAX package's order
    t0 = time.perf_counter()
    T = dict(plan.exchange_tables())
    T["A_hi"] = plan.elems_to_sharded(A_hi)
    T["A_lo"] = plan.elems_to_sharded(A_lo)
    T["B_hi"] = plan.elems_to_sharded(B_hi)
    T["B_lo"] = plan.elems_to_sharded(B_lo)
    del A_hi, A_lo, B_hi, B_lo
    # the f64 residual operators are UNEQUILIBRATED (the refinement driver
    # conjugates the inner system by D itself)
    T["A_64"] = plan.elems_to_sharded(lay.permute_blocks(A_loc))
    T["B_64"] = plan.elems_to_sharded(
        np.ascontiguousarray(B_np[:, :, lay.perm]))
    T["ext"] = plan.elems_to_sharded(AinvAis_perm.astype(np.float32))
    T["inner"] = plan.elems_to_sharded(A_ii_inv.astype(np.float32))
    T["freeF"] = plan.faces_to_sharded(freeF_np, fill=False)
    T["free_flat"] = plan.vel_to_sharded(free).reshape(n_shards, -1)
    # padded slots must scale by 1, not 0 (D multiplies iterates)
    ones_pad = plan.vel_to_sharded(np.ones(m.n))
    T["D"] = np.where(ones_pad > 0, plan.vel_to_sharded(D),
                      1.0).reshape(n_shards, -1)
    diag_Mp = np.maximum(np.asarray(m._diag_Mp, np.float64), 1e-300)
    T["dM"] = plan.p_to_sharded(diag_Mp, mQ, fill=1.0).reshape(
        n_shards, -1).astype(np.float32)
    # coarse tables: M_F rows + face vertex ids sharded by face owner;
    # DinvF (equilibration on face rows) sharded
    T["M_F"] = plan.faces_to_sharded(M_F.astype(np.float32), fill=0.0)
    T["fverts"] = plan.faces_to_sharded(faces_np.astype(np.int64))
    dinv = 1.0 / D
    DinvF_np = np.concatenate(
        [dinv[: lay.off_c].reshape(lay.nface, lay.nfd_v),
         dinv[lay.nhd:].reshape(lay.nface, lay.nfd_f)], axis=1)
    T["DinvF"] = plan.faces_to_sharded(DinvF_np.astype(np.float32),
                                       fill=0.0)

    # smoother buckets sharded: per bucket, the blocks assigned to each
    # shard (inverse tables + LOCAL face ids + mask), padded per shard
    T["buckets"], bucket_fsz = [], []
    b0 = 0
    for fb_np, inv_np in zip(sm.faces_np, bucket_inv):
        nb_b, fsz = fb_np.shape
        sel_by_shard = [
            np.where(np.asarray(blk_shard[b0: b0 + nb_b]) == s)[0]
            for s in range(n_shards)
        ]
        nb_max = max(max((len(x) for x in sel_by_shard), default=1), 1)
        inv_t = np.zeros((n_shards, nb_max, fsz * nfb, fsz * nfb),
                         np.float32)
        fl_t = np.full((n_shards, nb_max, fsz), plan.zero_row, np.int64)
        mask_t = np.zeros((n_shards, nb_max), np.float32)
        for s in range(n_shards):
            ks = sel_by_shard[s]
            inv_t[s, : len(ks)] = inv_np[ks]
            fl_t[s, : len(ks)] = plan.loc_id[s][fb_np[ks]]
            mask_t[s, : len(ks)] = 1.0
        T["buckets"].append(dict(inv=inv_t, floc=fl_t, mask=mask_t))
        bucket_fsz.append(fsz)
        b0 += nb_b

    color_meta = []
    if gs:
        S32 = S_perm.astype(np.float32)
        T["S"] = plan.elems_to_sharded(S32)
        colmask = freeF_np[efaces_np].reshape(lay.ne, n_skel)
        blocks_fb = [
            (np.asarray(f)[:, None] * nfb + np.arange(nfb)[None, :]).ravel()
            for f in block_faces
        ]
        colors = color_blocks(blocks_fb, lay.nface * nfb, lay.eldofs_fb)
        b0s = np.cumsum([0] + [len(f) for f in sm.faces_np])[:-1]
        T["colors"] = []
        for c in range(int(np.max(colors)) + 1):
            parts, meta = [], []
            for fb_np, inv_np, b0 in zip(sm.faces_np, bucket_inv, b0s):
                nb_b, fsz = fb_np.shape
                keep = np.where(colors[b0: b0 + nb_b] == c)[0]
                if not len(keep):
                    continue
                kshard = np.asarray(blk_shard[b0: b0 + nb_b])[keep]
                ks_by_shard = [keep[kshard == s] for s in range(n_shards)]
                nb_max = max(
                    max((len(x) for x in ks_by_shard), default=1), 1)
                inv_t = np.zeros(
                    (n_shards, nb_max, fsz * nfb, fsz * nfb), np.float32)
                fl_t = np.full((n_shards, nb_max, fsz), plan.zero_row,
                               np.int64)
                mask_t = np.zeros((n_shards, nb_max), np.float32)
                P2_t = np.zeros(
                    (n_shards, nb_max, fsz, nfb, 2 * n_skel), np.float32)
                ef2_t = np.full((n_shards, nb_max, fsz, 2, 4),
                                plan.zero_row, np.int64)
                for s in range(n_shards):
                    ks = ks_by_shard[s]
                    nk = len(ks)
                    inv_t[s, :nk] = inv_np[ks]
                    mask_t[s, :nk] = 1.0
                    faces = fb_np[ks]  # (nk, fsz)
                    fl_t[s, :nk] = plan.loc_id[s][faces]
                    slot = pos_np[faces]  # (nk, fsz, 2)
                    hit = slot < lay.ne * 4
                    e = np.where(hit, slot // 4, 0)
                    rows = ((slot % 4)[..., None] * nfb
                            + np.arange(nfb))  # (nk, fsz, 2, nfb)
                    pan = (S32[e[..., None], rows, :]
                           * colmask[e][:, :, :, None, :]
                           * freeF_np[faces][:, :, None, :, None])
                    pan = np.where(hit[..., None, None], pan, 0.0)
                    P2_t[s, :nk] = pan.transpose(0, 1, 3, 2, 4).reshape(
                        nk, fsz, nfb, 2 * n_skel)
                    ef2_t[s, :nk] = np.where(
                        hit[..., None], plan.loc_id[s][efaces_np[e]],
                        plan.zero_row)
                parts.append(dict(inv=inv_t, floc=fl_t, mask=mask_t,
                                  P2=P2_t, ef2=ef2_t))
                meta.append((fsz, nb_max))
            T["colors"].append(parts)
            color_meta.append(meta)
        # the example vector of the coarse damping's power iteration
        rng = np.random.default_rng(7)
        exF = (rng.standard_normal((lay.nface, nfb))
               * freeF_np).astype(np.float32)
        T["ex_fv"] = plan.faces_to_sharded(exF, fill=0.0).reshape(
            n_shards, -1)

    # the right-hand side of the initial solve, sharded
    f_mod = _np(torch.where(m.free, m.f - m.A_raw(m.u_bc), 0.0))
    g_mod = _np(-m.B_raw(m.u_bc))
    T["f"] = plan.vel_to_sharded(f_mod).reshape(n_shards, -1)
    T["g"] = plan.p_to_sharded(g_mod, mQ).reshape(n_shards, -1)
    seconds["shard tables"] = time.perf_counter() - t0
    seconds["all"] = time.perf_counter() - t_all

    common = dict(
        nfb=nfb, n_int=n_int, n_skel=n_skel, mQ=mQ, npad_f=plan.npad_f,
        ne_max=plan.ne_max, n_prod_pad=plan.n_prod_pad,
        n_halo_max=plan.n_halo_max, nloc=plan.nloc,
        nu=float(m.nu), mesh=m.Xv.mesh, dirichlet=m._dirich, gs=gs,
        bucket_fsz=bucket_fsz, color_meta=color_meta,
        coarse_target=coarse_target, ext_dtype=ext_dtype,
        inv_dtype=inv_dtype)
    return FastShardTables(plan, T, common, seconds)


class _RowScatter:
    """Deterministic scatter-add of (R, width) rows onto ``nrows`` rows
    (``ScatterPlan`` on the rows' entries); row indices < 0 are dropped."""

    def __init__(self, index: torch.Tensor, nrows: int, width: int):
        col = torch.arange(width, device=index.device)
        flat = torch.where(index[:, None] >= 0, index[:, None] * width + col,
                           -1)
        self.plan = ScatterPlan(flat, nrows * width)
        self.nrows, self.width = nrows, width

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        return self.plan(values).reshape(self.nrows, self.width)


def rank_fast_ops(t: dict, common: dict, mesh: DeviceMesh):
    """This rank's face-sharded operators from its host tables (``t`` =
    ``FastShardTables.rank(mesh.rank)``).

    Returns (ops32, ops64, D, aux): ``ops32`` = dict(A, B, BT, preA, preM)
    and ``ops64`` = dict(A, B, BT) acting on this rank's blocks (a
    velocity block of ``nloc`` entries, a pressure block of ne_max * mQ);
    ``D`` the equilibration in the velocity block; ``aux``: ``f`` and
    ``g`` (the right-hand side's blocks), ``mQ``, the coarse damping's
    ``lambda`` / ``theta`` (GS), ``tables`` (name -> the device table of
    every kernel launch of the applies) and ``seconds``."""
    from ..fem.spaces import H1
    from ..precond.multicolor import damped_coarse
    from ..precond.twolevel import coarse_p1_solver

    t_setup = time.perf_counter()
    dev = mesh.device
    f32, f64, i64 = torch.float32, torch.float64, torch.long
    c = common
    nfb, n_int, n_skel, mQ = c["nfb"], c["n_int"], c["n_skel"], c["mQ"]
    npad_f, ne_max, n_prod_pad = c["npad_f"], c["ne_max"], c["n_prod_pad"]
    nloc, nF = c["nloc"], c["npad_f"] * c["nfb"]
    ext_dt, inv_dt = c["ext_dtype"], c["inv_dtype"]

    def T(a, dt=None):
        return fresh_table(a, dev, dt)

    ex = {k: T(t[k], i64) for k in (
        "pack_slots", "pack_mask", "halo_src", "halo_mask", "rev_src",
        "rev_dst", "rev_mask", "efaces_loc", "pos2", "loc2op")}
    pack_m = ex["pack_mask"][:, None] > 0
    halo_m = ex["halo_mask"][:, None] > 0
    rev_m = ex["rev_mask"][:, None] > 0
    rev_scatter = _RowScatter(
        torch.where(ex["rev_mask"] > 0, ex["rev_dst"], -1), npad_f, nfb)
    efl = ex["efaces_loc"]
    pos2 = ex["pos2"]
    dump = npad_f + n_prod_pad  # loc2op's dropped row

    tables = {}

    def table(name, a, dt):
        tables[name] = T(a, dt)
        return tables[name]

    A_hi, A_lo = table("A_hi", t["A_hi"], f32), table("A_lo", t["A_lo"], f32)
    B_hi, B_lo = table("B_hi", t["B_hi"], f32), table("B_lo", t["B_lo"], f32)
    BT_hi = table("BT_hi", t["B_hi"].transpose(0, 2, 1), f32)
    BT_lo = table("BT_lo", t["B_lo"].transpose(0, 2, 1), f32)
    A_64 = table("A_64", t["A_64"], f64)
    B_64 = T(t["B_64"], f64)
    ext = table("ext", t["ext"], ext_dt)
    extT = table("ext^T", t["ext"].transpose(0, 2, 1), ext_dt)
    inner = table("inner", t["inner"], ext_dt)
    M_F = table("M_F", t["M_F"], f32)
    M_Ft = table("M_F^T", t["M_F"].transpose(0, 2, 1), f32)
    freeF = T(t["freeF"], torch.bool)
    free_flat = T(t["free_flat"], torch.bool)
    D = T(t["D"], f64)
    dM = T(t["dM"], f32)
    DinvF = T(t["DinvF"], f32)
    fverts = T(t["fverts"], i64)
    nv = c["mesh"].nv
    # padded face rows (M_F zero) add exact zeros: left out of the scatter
    live = torch.as_tensor(np.any(t["M_F"] != 0, axis=(1, 2)), device=dev)
    vert_scatter = ScatterPlan(torch.where(
        live[:, None, None],
        fverts[:, :, None] * 3 + torch.arange(3, device=dev), -1), nv * 3)
    solve1 = coarse_p1_solver(H1(c["mesh"], 1, dirichlet=c["dirichlet"]),
                              c["nu"], f32, dev)

    # -- the halo exchange ---------------------------------------------
    def halo_gather(uF_own):
        """uF_loc = [own rows | halo rows | zero row] via one all_gather."""
        packed = torch.where(pack_m, uF_own[ex["pack_slots"]], 0.0)
        every = mesh.all_gather(packed).reshape(-1, nfb)
        halo = torch.where(halo_m, every[ex["halo_src"]], 0.0)
        return torch.cat([uF_own, halo, uF_own.new_zeros((1, nfb))])

    def rev_fold(y_ownprod):
        """Fold the produce rows back onto their owners; own rows."""
        every = mesh.all_gather(y_ownprod[npad_f:]).reshape(-1, nfb)
        add = torch.where(rev_m, every[ex["rev_src"]], 0.0)
        return y_ownprod[:npad_f] + rev_scatter(add)

    def sibling_assemble(ye_skel):
        """(ne_max, 4*nfb) element skeleton results -> [own | produce]
        face rows via the two-sibling gather (scatter-free)."""
        yf = ye_skel.reshape(-1, nfb)
        yf = torch.cat([yf, yf.new_zeros((1, nfb))])
        return yf[pos2[:, 0]] + yf[pos2[:, 1]]

    def split_loc(xb):
        return xb[:nF].reshape(npad_f, nfb), xb[nF:].reshape(ne_max, n_int)

    def join_loc(uF, ui):
        return torch.cat([uF.reshape(-1), ui.reshape(-1)])

    def gather_elem(uF, ui):
        uF_loc = halo_gather(uF)
        return torch.cat([uF_loc[efl].reshape(ne_max, n_skel), ui],
                         dim=1).contiguous()

    # -- the saddle operators -------------------------------------------
    def A32_raw(x):
        ye = block_mv2(A_hi, A_lo, gather_elem(*split_loc(x)))
        yF = rev_fold(sibling_assemble(ye[:, :n_skel]))
        return join_loc(yF, ye[:, n_skel:])

    def B32_raw(x):
        return block_mv2(B_hi, B_lo, gather_elem(*split_loc(x))).reshape(-1)

    def BT32_raw(p):
        ye = block_mv2(BT_hi, BT_lo, p.reshape(ne_max, mQ).contiguous())
        yF = rev_fold(sibling_assemble(ye[:, :n_skel]))
        return join_loc(yF, ye[:, n_skel:])

    def A64_raw(x):
        ye = batched_local_matvec(A_64, gather_elem(*split_loc(x)))
        yF = rev_fold(sibling_assemble(ye[:, :n_skel]))
        return join_loc(yF, ye[:, n_skel:])

    def B64_raw(x):
        ue = gather_elem(*split_loc(x))
        return torch.einsum("epi,ei->ep", B_64, ue).reshape(-1)

    def BT64_raw(p):
        ye = torch.einsum("epi,ep->ei", B_64, p.reshape(ne_max, mQ))
        yF = rev_fold(sibling_assemble(ye[:, :n_skel]))
        return join_loc(yF, ye[:, n_skel:])

    def masked_A(Araw):
        def A(u):
            return torch.where(free_flat, Araw(torch.where(free_flat, u,
                                                           0.0)), u)
        return A

    def masked_B(Braw):
        return lambda u: Braw(torch.where(free_flat, u, 0.0))

    def masked_BT(BTraw):
        return lambda p: torch.where(free_flat, BTraw(p), 0.0)

    # -- the skeleton preconditioner ------------------------------------
    def coarse_rows(rF):
        """Aux-space P1 coarse: all_reduce'd vertex residual, replicated
        solve, local face rows (the sharded hybrid_h1_face_transfer)."""
        g = block_mv(M_Ft, (DinvF * rF).contiguous())  # (npad_f, 9)
        part = vert_scatter(g.reshape(npad_f, 3, 3)).reshape(nv, 3)
        z = solve1(mesh.all_reduce(part))  # replicated (nv, 3)
        cloc = z[fverts].reshape(npad_f, 9)
        return DinvF * block_mv(M_F, cloc.contiguous())

    def extT_rows(xF, xi):
        """Fold the interior residual into the skeleton (free-masked)."""
        r_op = sibling_assemble(-block_mv(extT, xi.contiguous()))
        r_op = torch.cat([r_op[:npad_f] + xF, r_op[npad_f:]])
        return torch.where(freeF, rev_fold(r_op), 0.0)

    def ext_inner(yF, xi):
        """Harmonic extension of skeleton values + exact interior solve."""
        ys = halo_gather(yF)[efl].reshape(ne_max, n_skel).contiguous()
        return -block_mv(ext, ys) + block_mv(inner, xi.contiguous())

    aux = dict(mQ=mQ, tables=tables)
    if not c["gs"]:
        buckets = []
        for i, (bt, fsz) in enumerate(zip(t["buckets"], c["bucket_fsz"])):
            floc = T(bt["floc"], i64)
            tgt = ex["loc2op"][floc.reshape(-1)]
            buckets.append((table(f"edge-star inv {fsz} faces", bt["inv"],
                                  f32), floc, T(bt["mask"], f32),
                            torch.where(tgt == dump, -1, tgt), fsz))
        smooth_scatter = _RowScatter(torch.cat([b[3] for b in buckets]),
                                     npad_f + n_prod_pad, nfb)

        def pre_skel(rF):
            # one halo refresh serves every smoother block on this rank
            rF_loc = halo_gather(rF)
            parts = []
            for inv, floc, mask, _, fsz in buckets:
                xb = rF_loc[floc].reshape(inv.shape[0], fsz * nfb)
                yb = block_mv(inv, xb.contiguous()) * mask[:, None]
                parts.append(yb.reshape(-1, nfb))
            yF_sm = rev_fold(smooth_scatter(torch.cat(parts)))
            return torch.where(freeF, yF_sm + coarse_rows(rF), 0.0)
    else:
        S = table("S", t["S"], f32)
        # per color, the parts (one per edge-star size) merged: one panel
        # table over all the color's block-face rows (kernel 1) and one
        # segment table of its inverses (kernel 1 over ragged blocks), so
        # a color step is two launches whatever its part count
        colors = []
        for ci, (ct, meta) in enumerate(zip(t["colors"], c["color_meta"])):
            nrow = sum(fsz * nb for fsz, nb in meta)
            nblk = sum(nb for _, nb in meta)
            fsz_max = max(fsz for fsz, _ in meta)
            rows = np.full((nblk, fsz_max), nrow, np.int64)  # pad: zero row
            r0 = b0 = 0
            for fsz, nb in meta:
                rows[b0: b0 + nb, :fsz] = r0 + np.arange(nb * fsz).reshape(
                    nb, fsz)
                r0, b0 = r0 + nb * fsz, b0 + nb
            floc = T(np.concatenate([pt["floc"].reshape(-1) for pt in ct]),
                     i64)
            rows_t = T(rows, i64)
            tgt = ex["loc2op"][torch.cat([floc, floc.new_full(
                (1,), c["npad_f"] + c["n_halo_max"])])][rows_t]
            P2 = table(f"GS color {ci} panels", np.concatenate(
                [pt["P2"].reshape(-1, nfb, 2 * n_skel) for pt in ct]), f32)
            solve = make_segment_apply(
                [torch.as_tensor(pt["inv"]) for pt in ct], nblk,
                fsz_max * nfb, inv_dt, dev)
            tables[f"GS color {ci} solve"] = solve.table
            colors.append(dict(
                floc=floc, rows=rows_t, P2=P2, solve=solve,
                ef2=T(np.concatenate([pt["ef2"].reshape(-1, 8)
                                      for pt in ct]), i64),
                mask=T(np.concatenate([pt["mask"] for pt in ct]), f32),
                scatter=_RowScatter(torch.where(tgt == dump, -1, tgt)
                                    .reshape(-1), npad_f + n_prod_pad,
                                    nfb)))

        def S_rows(y_loc):
            ue = y_loc[efl].reshape(ne_max, n_skel).contiguous()
            return rev_fold(sibling_assemble(block_mv(S, ue)))

        def S_fv(xf):
            xF = torch.where(freeF, xf.reshape(npad_f, nfb), 0.0)
            return torch.where(freeF, S_rows(halo_gather(xF)),
                               0.0).reshape(-1)

        def coarse_fv(rf):
            yc = coarse_rows(rf.reshape(npad_f, nfb))
            return torch.where(freeF, yc, 0.0).reshape(-1)

        # the coarse damping scale: power-iterate lambda_max(C S) with the
        # sharded face-vector operators
        _, lam, theta = damped_coarse(coarse_fv, S_fv, T(t["ex_fv"], f32),
                                      target=c["coarse_target"], group=mesh)
        aux.update(coarse_lambda=lam, coarse_theta=theta)

        def color_update(g, xF_loc, y, y_loc):
            """One color: fresh residual at this color's faces from ROW
            PANELS of S, batched block solves, owner fold."""
            rc = xF_loc[g["floc"]]  # (rows, nfb)
            if y_loc is not None:  # a zero iterate: the residual is x
                ye2 = y_loc[g["ef2"]].reshape(-1, 2 * n_skel)
                rc = rc - block_mv(g["P2"], ye2.contiguous())
            xb = torch.cat([rc, rc.new_zeros((1, nfb))])[g["rows"]]
            yb = g["solve"](xb.reshape(g["rows"].shape[0], -1))
            yb = yb * g["mask"][:, None]
            return y + rev_fold(g["scatter"](yb.reshape(-1, nfb)))

        def pre_skel(rF):
            xF_loc = halo_gather(rF)
            y = rF.new_zeros((npad_f, nfb))
            y_loc = None
            for g in colors:  # forward
                y = color_update(g, xF_loc, y, y_loc)
                y_loc = halo_gather(y)
            # damped coarse correction on the fresh residual
            Sy = torch.where(freeF, S_rows(y_loc), 0.0)
            y = y + theta * torch.where(freeF, coarse_rows(rF - Sy), 0.0)
            for g in reversed(colors):  # backward
                y_loc = halo_gather(y)
                y = color_update(g, xF_loc, y, y_loc)
            return y

    def preA(x):
        xF, xi = split_loc(torch.where(free_flat, x, 0.0))
        rF = extT_rows(xF, xi)
        yF = pre_skel(rF)
        y = join_loc(yF, ext_inner(yF, xi))
        return torch.where(free_flat, y, x)

    nu32 = float(np.float32(c["nu"]))

    def preM(p):
        return nu32 * p / dM.to(p.dtype)

    ops32 = dict(A=masked_A(A32_raw), B=masked_B(B32_raw),
                 BT=masked_BT(BT32_raw), preA=preA, preM=preM)
    ops64 = dict(A=masked_A(A64_raw), B=masked_B(B64_raw),
                 BT=masked_BT(BT64_raw))
    aux.update(f=T(t["f"], f64), g=T(t["g"], f64), free_flat=free_flat,
               seconds=time.perf_counter() - t_setup)
    if nloc != D.numel():
        raise AssertionError(f"velocity block of {D.numel()}, plan {nloc}")
    return ops32, ops64, D, aux


def build_sharded_fast_ops(m, mesh: DeviceMesh, axis: str = "shard",
                           gs: bool = False, **storage):
    """Shard the production split-f32 operator stack + preconditioner of a
    3D MCS model over ``mesh``'s ranks (every rank calls this with its
    model).  Returns (ops32, ops64, D, plan, aux): the ops act on this
    rank's blocks; ``D`` the equilibration diagonal in this rank's
    velocity block; ``aux`` as :func:`rank_fast_ops`'s, with the host
    ``seconds`` by part under ``host_seconds``.  ``storage``: see
    :func:`shard_fast_tables`."""
    host = shard_fast_tables(m, mesh.shape[axis], gs=gs, **storage)
    ops32, ops64, D, aux = rank_fast_ops(host.rank(mesh.rank), host.common,
                                         mesh)
    aux["host_seconds"] = host.seconds
    return ops32, ops64, D, host.plan, aux


def fast_refinement(ops32, ops64, D, f, g, mesh: DeviceMesh,
                    tol: float = 1e-8, inner_tol: float = 1e-5,
                    inner_maxsteps: int = 800, max_refine: int = 8,
                    two_phase: bool = True):
    """The single-device drivers on this rank's blocks, every inner product
    summed over the ranks: ``mixed_precision_minres_refinement_2phase``, or
    ``mixed_precision_minres_refinement`` with the deep-tolerance
    ``abs_test`` (:data:`~navier_stokes_tpu_torch.solvers.refinement.
    DEEP_ABS_TEST`) when ``two_phase=False``.  Returns (x, rel, passes,
    inner): ``passes`` (p1, p2) when two_phase, else an int."""
    from ..solvers.refinement import (
        DEEP_ABS_TEST,
        mixed_precision_minres_refinement,
        mixed_precision_minres_refinement_2phase,
    )

    kw = dict(tol=tol, inner_tol=inner_tol, inner_maxsteps=inner_maxsteps,
              max_refine=max_refine, group=mesh)
    if two_phase:
        return mixed_precision_minres_refinement_2phase(ops64, ops32, D, f,
                                                        g, **kw)
    return mixed_precision_minres_refinement(ops64, ops32, D, f, g,
                                             abs_test=DEEP_ABS_TEST, **kw)


def fast_ops_rank(mesh: DeviceMesh, t: dict, common: dict, u_sh, p_sh):
    """Rank body: this rank's operators applied once each to its blocks of
    the sharded flat velocity ``u_sh`` and pressure ``p_sh`` (the f32 ops
    to their f32 casts, the f64 ops to f64).  Returns name -> the whole
    sharded result (gathered): ``A``, ``preA``, ``B``, ``BT``, ``preM``,
    ``A64``, ``B64``, ``BT64`` and the equilibration ``D``."""
    ops32, ops64, D, _ = rank_fast_ops(t, common, mesh)
    dev, r = mesh.device, mesh.rank
    nloc, npl = common["nloc"], common["ne_max"] * common["mQ"]
    u = torch.as_tensor(u_sh)[r * nloc:(r + 1) * nloc].to(dev)
    p = torch.as_tensor(p_sh)[r * npl:(r + 1) * npl].to(dev)
    u32, p32 = u.to(torch.float32), p.to(torch.float32)
    u64, p64 = u.to(torch.float64), p.to(torch.float64)
    out = dict(A=ops32["A"](u32), preA=ops32["preA"](u32),
               B=ops32["B"](u32), BT=ops32["BT"](p32),
               preM=ops32["preM"](p32), A64=ops64["A"](u64),
               B64=ops64["B"](u64), BT64=ops64["BT"](p64), D=D)
    return {k: mesh.all_gather(v).reshape(-1) for k, v in out.items()}


def fast_solve_rank(mesh: DeviceMesh, t: dict, common: dict, kw: dict,
                    ops=None):
    """Rank body of :func:`sharded_fast_flagship_solve`: this rank's
    operators (or ``ops`` = (ops32, ops64, D, aux) already built), the
    refinement driver (``kw``: :func:`fast_refinement`'s settings), the
    solution's blocks gathered.  Returns a dict: ``x_u`` / ``x_p`` (the
    whole sharded flat vectors), ``rel``, ``passes``, ``inner``, setup and
    solve seconds, and this rank's collective calls and kernel launches
    during the solve."""
    from ..ops.block_mv import LAUNCHES, reset_launches

    if ops is None:
        ops = rank_fast_ops(t, common, mesh)
    ops32, ops64, D, aux = ops
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0
    reset_launches()
    t0 = time.perf_counter()
    x, rel, passes, inner = fast_refinement(ops32, ops64, D, aux["f"],
                                            aux["g"], mesh, **kw)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    secs = time.perf_counter() - t0
    stats = dict(collectives=dict(COLLECTIVES), launches=dict(LAUNCHES))
    return dict(x_u=mesh.all_gather(x[0]).reshape(-1),
                x_p=mesh.all_gather(x[1]).reshape(-1), rel=rel,
                passes=passes, inner=inner, setup_seconds=aux["seconds"],
                solve_seconds=secs, coarse_theta=aux.get("coarse_theta"),
                **stats)


def sharded_fast_flagship_solve(ns, mesh, tol: float = 1e-8,
                                inner_tol: float = 1e-5,
                                inner_maxsteps: int = 800,
                                max_refine: int = 8,
                                axis: str = "shard",
                                gs: bool = True,
                                two_phase: bool = True,
                                ops=None, **storage):
    """SolveInitial of the flagship MCS model with the production fast
    path sharded: split-f32 equilibrated operators, scatter-free
    face-block applies, skeleton smoother + aux-space coarse, f32 MINRES
    refinement passes -- the same drivers as the single-device solve
    (:func:`fast_refinement`), on this rank's blocks.

    ``mesh``: this rank's :class:`~.sharding.DeviceMesh` (every rank calls
    this with its model), or a :class:`~.sharding.Ranks` to start that
    many rank processes from here.  ``ops``: this rank's (ops32, ops64, D,
    plan, aux) of :func:`build_sharded_fast_ops`, built already (a
    DeviceMesh only).  ``storage``: see :func:`shard_fast_tables`.

    Returns ((x_u, x_p) global numpy, rel_residual, passes, total_inner,
    plan); ``passes`` is (p1, p2) when two_phase else a single int.
    ``plan.run_stats`` holds rank 0's setup and solve seconds, collective
    calls and kernel launches of the solve."""
    kw = dict(tol=tol, inner_tol=inner_tol, inner_maxsteps=inner_maxsteps,
              max_refine=max_refine, two_phase=two_phase)
    if ops is not None:
        if isinstance(mesh, Ranks):
            raise ValueError("prebuilt ops belong to an in-process rank")
        ops32, ops64, D, plan, aux = ops
        out = fast_solve_rank(mesh, None, None, kw,
                              ops=(ops32, ops64, D, aux))
    else:
        host = shard_fast_tables(ns, mesh.shape[axis], gs=gs, **storage)
        plan = host.plan
        if isinstance(mesh, Ranks):
            out = mesh.run(fast_solve_rank, host.common, kw, rank_args=[
                host.rank(s) for s in range(mesh.world_size)])
        else:
            out = fast_solve_rank(mesh, host.rank(mesh.rank), host.common,
                                  kw)
        out["host_seconds"] = host.seconds
    mQ = int(np.asarray(ns.Q.element_dofs).shape[1])
    x_u = plan.vel_to_global(_np(out["x_u"]))
    x_p = plan.p_to_global(_np(out["x_p"]), mQ)
    plan.run_stats = {k: v for k, v in out.items()
                      if k not in ("x_u", "x_p")}
    return (x_u, x_p), float(out["rel"]), out["passes"], int(out["inner"]), \
        plan

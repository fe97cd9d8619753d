"""Dof-sharded domain-decomposition operators (halo exchange, not
replication), on ``torch.distributed``.

Counterpart of ``navier_stokes_tpu/parallel/ddshard.py``.  Dof vectors
are PARTITIONED across the ranks (one padded block per rank, the layout of
:class:`DofPartition`), and a matrix-free apply moves only interface data:

1. each rank packs the owned dofs that other ranks' elements touch into a
   fixed-size buffer;
2. one ``all_gather`` of the packed buffers;
3. local gather -> kernel 8 (``ops/local_mv.batched_local_matvec``, in the
   tables' dtype; a rectangular coupling is zero-padded to square blocks)
   -> ``ScatterPlan`` over [own | halo];
4. the contributions a rank computed for dofs owned elsewhere go back by a
   second packed ``all_gather`` and are added by their owners.

The host part (:func:`dd_operator_tables`: partitions, packing, every
rank's index tables) is the JAX package's numpy code; each rank then moves
only its own tables to its device (:func:`rank_dd_operator`).  Krylov
inner products on the partitioned vectors are local dots summed by one
``all_reduce`` (the drivers' ``group`` argument).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.assembly import ScatterPlan
from ..ops.local_mv import batched_local_matvec
from .sharding import DeviceMesh, Ranks, fresh_table

__all__ = ["DofPartition", "partition_dofs", "block_element_partition",
           "dd_operator_tables", "rank_dd_operator", "build_dd_operator",
           "dd_flagship_tables", "dd_solve_rank", "sharded_flagship_solve"]


@dataclass(frozen=True)
class DofPartition:
    """Partition of a dof space into n_shards padded blocks.

    ``owner``: (ndof,) shard id per dof; ``slot``: (ndof,) position within
    the owner's block; ``npad``: slots per shard (max count, padded).
    The sharded vector layout is x_sh[s * npad + slot] = x_global[dof].
    """

    n_shards: int
    ndof: int
    npad: int
    owner: np.ndarray
    slot: np.ndarray

    @property
    def ntotal(self) -> int:
        return self.n_shards * self.npad

    def to_sharded(self, x: np.ndarray) -> np.ndarray:
        out = np.zeros(self.ntotal, dtype=x.dtype)
        out[self.owner * self.npad + self.slot] = x
        return out

    def to_global(self, xs: np.ndarray) -> np.ndarray:
        return np.asarray(xs)[self.owner * self.npad + self.slot]


def partition_dofs(eldofs: np.ndarray, ndof: int, n_shards: int,
                   elem_shard: np.ndarray) -> DofPartition:
    """First-touch dof partition: a dof is owned by the lowest shard whose
    elements reference it; dofs referenced by no element go to shard 0."""
    owner = np.full(ndof, n_shards, dtype=np.int64)
    for s in range(n_shards - 1, -1, -1):
        sel = np.where(elem_shard == s)[0]
        owner[np.unique(eldofs[sel])] = s
    owner[owner == n_shards] = 0
    slot = np.zeros(ndof, dtype=np.int64)
    counts = np.zeros(n_shards, dtype=np.int64)
    for s in range(n_shards):
        idx = np.where(owner == s)[0]
        slot[idx] = np.arange(len(idx))
        counts[s] = len(idx)
    npad = int(counts.max())
    return DofPartition(n_shards, ndof, npad, owner, slot)


def block_element_partition(ne: int, n_shards: int) -> np.ndarray:
    """Contiguous element blocks (generators emit spatially-ordered
    elements, so blocks are slabs)."""
    return np.minimum((np.arange(ne) * n_shards) // max(ne, 1),
                      n_shards - 1)


def _pad_rows(rows: list[np.ndarray], fill: int) -> np.ndarray:
    m = max((len(r) for r in rows), default=0)
    m = max(m, 1)
    out = np.full((len(rows), m), fill, dtype=np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def dd_operator_tables(mats: np.ndarray, eldofs_out: np.ndarray,
                       eldofs_in: np.ndarray, part_out: DofPartition,
                       part_in: DofPartition, elem_shard: np.ndarray,
                       n_shards: int) -> dict:
    """Every shard's host tables of the sharded apply y = sum_e P_out^T
    mats[e] P_in x (the host half of the JAX package's
    ``build_dd_operator``): numpy arrays with a leading shard axis --
    ``mats`` (n, ne_max, nout, nin), local in/out element dofs ``edin`` /
    ``edout``, the halo fetch positions ``halo`` (+ ``hmask``), the packed
    own slots ``pack`` (+ ``pmask``), the reverse fold ``rsrc`` / ``rdst``
    (+ ``rmask``) -- and the sizes ``npad_in``, ``npad_out``, ``Hmax``."""
    ne, nout, nin = mats.shape
    npad_in, npad_out = part_in.npad, part_out.npad

    shard_mats, shard_eldofs_in, shard_eldofs_out = [], [], []
    halo_in_rows, pack_in_rows = [], []
    rev_src_rows, rev_dst_rows = [], []

    # forward packing: for each shard, the owned IN-dofs other shards touch
    need = [set() for _ in range(n_shards)]
    for s in range(n_shards):
        sel = np.where(elem_shard == s)[0]
        need[s] = set(np.unique(eldofs_in[sel]).tolist())
    pack_in: list[list[int]] = [[] for _ in range(n_shards)]
    pack_pos: list[dict] = [dict() for _ in range(n_shards)]
    for s in range(n_shards):
        for d in sorted(need[s]):
            o = int(part_in.owner[d])
            if o != s and d not in pack_pos[o]:
                pack_pos[o][d] = len(pack_in[o])
                pack_in[o].append(d)
    Bmax = max(max((len(p) for p in pack_in), default=1), 1)

    # reverse packing (OUT side): contributions for foreign out-dofs
    prod = [set() for _ in range(n_shards)]
    for s in range(n_shards):
        sel = np.where(elem_shard == s)[0]
        prod[s] = set(np.unique(eldofs_out[sel]).tolist())
    out_halo: list[list[int]] = []
    for s in range(n_shards):
        out_halo.append(
            sorted(d for d in prod[s] if int(part_out.owner[d]) != s)
        )
    Hmax = max(max((len(h) for h in out_halo), default=1), 1)

    for s in range(n_shards):
        sel = np.where(elem_shard == s)[0]
        m = np.zeros((0, nout, nin)) if not len(sel) else mats[sel]
        shard_mats.append(m)
        # IN index: owned -> slot, foreign -> npad_in + halo position
        halo_list = sorted(
            d for d in need[s] if int(part_in.owner[d]) != s
        )
        halo_pos = {d: i for i, d in enumerate(halo_list)}
        ed_in = eldofs_in[sel].astype(np.int64)
        loc_in = np.zeros_like(ed_in)
        own_mask = part_in.owner[ed_in] == s
        loc_in[own_mask] = part_in.slot[ed_in[own_mask]]
        if (~own_mask).any():
            loc_in[~own_mask] = npad_in + np.asarray(
                [halo_pos[int(d)] for d in ed_in[~own_mask]]
            )
        shard_eldofs_in.append(loc_in)
        # halo fetch positions in the all-gathered (n_shards * Bmax) buffer
        halo_in_rows.append(
            np.asarray(
                [int(part_in.owner[d]) * Bmax
                 + pack_pos[int(part_in.owner[d])][d] for d in halo_list],
                dtype=np.int64,
            )
        )
        pack_in_rows.append(
            np.asarray([part_in.slot[d] for d in pack_in[s]], dtype=np.int64)
        )
        # OUT index: owned -> slot, foreign -> npad_out + out-halo position
        oh = out_halo[s]
        oh_pos = {d: i for i, d in enumerate(oh)}
        ed_out = eldofs_out[sel].astype(np.int64)
        loc_out = np.zeros_like(ed_out)
        o_mask = part_out.owner[ed_out] == s
        loc_out[o_mask] = part_out.slot[ed_out[o_mask]]
        if (~o_mask).any():
            loc_out[~o_mask] = npad_out + np.asarray(
                [oh_pos[int(d)] for d in ed_out[~o_mask]]
            )
        shard_eldofs_out.append(loc_out)

    # reverse-add tables: for shard t, where in the gathered (n_shards*Hmax)
    # reverse buffer do entries destined to t live, and at which own slot
    for t in range(n_shards):
        src, dst = [], []
        for s in range(n_shards):
            for i, d in enumerate(out_halo[s]):
                if int(part_out.owner[d]) == t:
                    src.append(s * Hmax + i)
                    dst.append(int(part_out.slot[d]))
        rev_src_rows.append(np.asarray(src, dtype=np.int64))
        rev_dst_rows.append(np.asarray(dst, dtype=np.int64))

    # pad per-shard tables to common shapes; padded elements have zero
    # mats, so their scatter target (slot 0) is harmless
    ne_max = max(max((m.shape[0] for m in shard_mats), default=1), 1)

    def pad_elems(arrs):
        return np.stack([np.concatenate(
            [a, np.zeros((ne_max - a.shape[0],) + a.shape[1:], a.dtype)])
            for a in arrs])

    return dict(
        mats=pad_elems(shard_mats), edin=pad_elems(shard_eldofs_in),
        edout=pad_elems(shard_eldofs_out),
        halo=_pad_rows(halo_in_rows, fill=0),
        hmask=_pad_rows([np.ones(len(r), np.int64) for r in halo_in_rows],
                        fill=0),
        pack=_pad_rows(pack_in_rows, fill=0),
        pmask=_pad_rows([np.ones(len(r), np.int64) for r in pack_in_rows],
                        fill=0),
        rsrc=_pad_rows(rev_src_rows, fill=0),
        rdst=_pad_rows(rev_dst_rows, fill=0),
        rmask=_pad_rows([np.ones(len(r), np.int64) for r in rev_src_rows],
                        fill=0),
        npad_in=npad_in, npad_out=npad_out, Hmax=Hmax)


def _shard(tables: dict, s: int) -> dict:
    """Shard ``s``'s tables of :func:`dd_operator_tables` (the sizes
    kept)."""
    return {k: (v[s] if isinstance(v, np.ndarray) else v)
            for k, v in tables.items()}


def rank_dd_operator(tab: dict, mesh: DeviceMesh, dtype=torch.float64):
    """This rank's apply of a sharded operator from its tables (one shard
    of :func:`dd_operator_tables`): x (npad_in,) own block -> y
    (npad_out,) own block, through two ``all_gather``s, kernel 8 in
    ``dtype`` and two ``ScatterPlan``s.  ``apply.table``: the device table
    (square: a rectangular coupling is zero-padded to its larger side)."""
    dev = mesh.device
    mats = tab["mats"]
    ne_max, nout, nin = mats.shape
    nsq = max(nout, nin)
    sq = np.zeros((ne_max, nsq, nsq), mats.dtype)
    sq[:, :nout, :nin] = mats
    m = fresh_table(sq, dev, dtype)
    npad_in, npad_out = tab["npad_in"], tab["npad_out"]

    def idx(a):
        return fresh_table(a, dev, torch.long)

    edi = idx(tab["edin"])
    pack, pmask = idx(tab["pack"]), idx(tab["pmask"]) > 0
    halo, hmask = idx(tab["halo"]), idx(tab["hmask"]) > 0
    rsrc, rmask = idx(tab["rsrc"]), idx(tab["rmask"]) > 0
    # rows of the tables that are all zero (padded elements, padded block
    # rows) add exact zeros: leave them out of the scatter, which would
    # otherwise pile them all onto slot 0
    live = np.any(mats != 0, axis=2)
    plan_out = ScatterPlan(idx(np.where(live, tab["edout"], -1)),
                           npad_out + tab["Hmax"])
    plan_rev = ScatterPlan(
        idx(np.where(tab["rmask"] > 0, tab["rdst"], -1)), npad_out)

    def apply(x):
        packed = torch.where(pmask, x[pack], 0.0)
        every = mesh.all_gather(packed).reshape(-1)
        x_loc = torch.cat([x, torch.where(hmask, every[halo], 0.0)])
        ue = x_loc[edi]
        if nin < nsq:
            ue = torch.cat([ue, ue.new_zeros((ne_max, nsq - nin))], dim=1)
        ye = batched_local_matvec(m, ue.contiguous())[:, :nout]
        y = plan_out(ye)
        every = mesh.all_gather(y[npad_out:]).reshape(-1)
        return y[:npad_out] + plan_rev(torch.where(rmask, every[rsrc], 0.0))

    apply.table = m
    return apply


def build_dd_operator(mats: np.ndarray, eldofs_out: np.ndarray,
                      eldofs_in: np.ndarray, part_out: DofPartition,
                      part_in: DofPartition, elem_shard: np.ndarray,
                      mesh: DeviceMesh, dtype=torch.float64,
                      axis: str = "shard"):
    """Sharded matrix-free apply y = sum_e P_out^T mats[e] P_in x on this
    rank's blocks of partitioned padded vectors.

    ``mats``: (ne, nout, nin) local matrices; rectangular operators (the
    divergence coupling B / B^T) just use different in/out tables and
    partitions."""
    tables = dd_operator_tables(mats, eldofs_out, eldofs_in, part_out,
                                part_in, elem_shard, mesh.shape[axis])
    return rank_dd_operator(_shard(tables, mesh.rank), mesh, dtype)


def dd_flagship_tables(ns, n_shards: int) -> tuple[list, DofPartition,
                                                   DofPartition]:
    """The host half of :func:`sharded_flagship_solve`: the partitions and,
    per shard, the tables of A, B, B^T and the block smoother (2D vertex
    stars / 3D disjoint face+interior blocks, the model's
    ``preconditioner="vertexstar"`` / ``"faceblock"``) and the shard's
    blocks of the free mask, right-hand side and pressure-mass diagonal.
    Returns (per-shard bundles, part_u, part_p)."""
    from ..models.stokes_hybrid import hybrid_blocks
    from ..precond.jacobi import extract_blocks_from_local

    eldofs = np.asarray(ns.Xv.element_dofs)
    eldofs_p = np.asarray(ns.Q.element_dofs)
    es = block_element_partition(ns.mesh.ne, n_shards)
    pu = partition_dofs(eldofs, ns.n, n_shards, es)
    pp = partition_dofs(eldofs_p, ns.Q.ndof, n_shards, es)

    B_loc = np.asarray(ns.B_loc_np)
    ops = dict(
        A=dd_operator_tables(ns.A_cond_np, eldofs, eldofs, pu, pu, es,
                             n_shards),
        B=dd_operator_tables(B_loc, eldofs_p, eldofs, pp, pu, es, n_shards),
        BT=dd_operator_tables(B_loc.transpose(0, 2, 1), eldofs, eldofs_p,
                              pu, pp, es, n_shards))
    if ns.mesh.dim == 3:
        from ..models.stokes_hybrid3d import hybrid_blocks_3d

        fmask = ns.Xv.free_mask
        blocks = [
            np.asarray([d for d in b if fmask[d]], np.int32)
            for b in hybrid_blocks_3d(ns.Xv, "face")
        ]
        blocks = [b for b in blocks if len(b)]
    else:
        blocks = hybrid_blocks(ns.Xv, "vertexstar")
    dofs_pad, mats = extract_blocks_from_local(ns.A_cond_np, eldofs, blocks,
                                               ns.n)
    inv = np.linalg.inv(np.asarray(mats, np.float64))
    pad = dofs_pad < 0
    inv = inv * (~pad[:, :, None]) * (~pad[:, None, :])
    dofs0 = np.where(pad, 0, dofs_pad)
    blk_shard = pu.owner[dofs0[:, 0]]
    ops["pre"] = dd_operator_tables(inv, dofs0, dofs0, pu, pu, blk_shard,
                                    n_shards)

    def host(t):
        return t.detach().cpu().numpy()

    f_mod = host(torch.where(ns.free, ns.f - ns.A_raw(ns.u_bc), 0.0))
    g_mod = host(-ns.B_raw(ns.u_bc))
    free_sh = pu.to_sharded(host(ns.free)).reshape(n_shards, -1)
    f_sh = pu.to_sharded(f_mod).reshape(n_shards, -1)
    g_sh = pp.to_sharded(g_mod).reshape(n_shards, -1)
    diag = pp.to_sharded(np.maximum(np.asarray(ns._diag_Mp), 1e-30))
    # padded pressure slots carry 0: use 1.0 there instead
    diag = np.where(diag > 1e-29, diag, 1.0).reshape(n_shards, -1)
    bundles = [dict(ops={k: _shard(v, s) for k, v in ops.items()},
                    free=free_sh[s], f=f_sh[s], g=g_sh[s], diag_Mp=diag[s],
                    nu=float(ns.nu), dtype=ns.dtype)
               for s in range(n_shards)]
    return bundles, pu, pp


def dd_solve_rank(mesh: DeviceMesh, bundle: dict, tol: float = 1e-8,
                  maxsteps: int = 4000, scale_k=None,
                  local_dots: bool = False):
    """Rank body of :func:`sharded_flagship_solve`: this rank's operators
    from its bundle (:func:`dd_flagship_tables`), BPCG v2 with every inner
    product summed over the ranks, and the solution's blocks gathered.
    ``local_dots=True`` is a control that leaves the inner products local
    (the ranks then disagree on the step lengths).  Returns (result with
    ``x`` = the whole partitioned (u, p) on every rank, launches of this
    rank's kernels during the solve)."""
    from ..ops.block_mv import LAUNCHES, reset_launches
    from ..solvers.bpcg import bramble_pasciak_cg_opt

    dev, dt = mesh.device, bundle["dtype"]
    A_dd, B_dd, BT_dd, pre_dd = (rank_dd_operator(bundle["ops"][k], mesh, dt)
                                 for k in ("A", "B", "BT", "pre"))
    free = torch.as_tensor(bundle["free"], device=dev)
    f, g, diag = (fresh_table(bundle[k], dev, dt)
                  for k in ("f", "g", "diag_Mp"))
    nu = bundle["nu"]

    def A(x):
        return torch.where(free, A_dd(torch.where(free, x, 0.0)), x)

    def B(x):
        return B_dd(torch.where(free, x, 0.0))

    def BT(p):
        return torch.where(free, BT_dd(p), 0.0)

    def preA(x):
        return torch.where(free, pre_dd(torch.where(free, x, 0.0)), x)

    def preM(p):
        return nu * p / diag

    reset_launches()
    res = bramble_pasciak_cg_opt(A, B, BT, preA, preM, f, g, tol=tol,
                                 maxsteps=maxsteps, rel_err=True,
                                 scale_k=scale_k,
                                 group=None if local_dots else mesh)
    launches = dict(LAUNCHES)
    res.x = tuple(mesh.all_gather(v).reshape(-1) for v in res.x)
    return res, launches


def sharded_flagship_solve(ns, mesh, tol: float = 1e-8,
                           maxsteps: int = 4000, axis: str = "shard",
                           scale_k=None):
    """Full Bramble-Pasciak SolveInitial of the flagship MCS model with
    dof-SHARDED vectors.

    A / B / B^T and the vertex-star (2D) or face-block (3D) smoother all
    run through the interface-packed halo exchange; Krylov dots are local
    dots summed over the ranks.  ``mesh``: this rank's
    :class:`~.sharding.DeviceMesh` (every rank calls this with its model),
    or a :class:`~.sharding.Ranks` to start that many rank processes from
    here.  ``scale_k``: the Bramble-Pasciak scaling (from a Lanczos on the
    sharded vectors when None).  Returns (result, part_u, part_p): the
    result's ``x`` is the whole partitioned (u, p), mapped back with
    ``part.to_global``."""
    n_shards = mesh.shape[axis]
    bundles, pu, pp = dd_flagship_tables(ns, n_shards)
    if isinstance(mesh, Ranks):
        res, _ = mesh.run(dd_solve_rank, tol, maxsteps, scale_k,
                          rank_args=bundles)
    else:
        res, _ = dd_solve_rank(mesh, bundles[mesh.rank], tol, maxsteps,
                               scale_k)
    return res, pu, pp

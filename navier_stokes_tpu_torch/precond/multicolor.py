"""Multi-color block Gauss-Seidel: coloring, sweeps and coarse damping.

Counterpart of ``navier_stokes_tpu/precond/multicolor.py``
(``color_blocks`` with its element-clique branch, ``MulticolorGS``,
``damped_coarse`` and ``symmetric_gs_preconditioner``).  Blocks are colored
so that same-color blocks are operator-decoupled; each color is then
updated as ONE batched dense block solve (gather -> batched matvec ->
scatter) with a fresh residual per color.  The symmetric preconditioner
(forward sweep, coarse correction, backward sweep) is the reference's
MypreA.Mult with GS=True.

The skeleton preconditioner's own sweep over row panels lives with the
face-block smoother (ops/faceblock.FaceStarSmoother.solve_color_rows) and
models/auxspace3d.py; :class:`MulticolorGS` sweeps dof-level blocks with a
full operator apply per color (the 3D model's faceblock GS preconditioner).
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from ..device import resolve_device
from ..linalg.pytree import tnorm
from ..ops.assembly import ScatterPlan
from ..ops.local_mv import batched_local_matvec

__all__ = ["color_blocks", "MulticolorGS", "damped_coarse",
           "symmetric_gs_preconditioner"]


def color_blocks(blocks: list[np.ndarray], ndof: int,
                 eldofs: np.ndarray) -> np.ndarray:
    """Greedy coloring of dof blocks for multiplicative sweeps: blocks that
    touch a common element (a row of ``eldofs``) get different colors, so
    same-color blocks are operator-decoupled, not merely dof-disjoint.

    Smallest-last (degeneracy) order through a heap keyed on (degree,
    block index), then first-fit in the reverse of that order -- the JAX
    package's order, so the two give the same colors on the same blocks."""
    nb = len(blocks)
    colors = -np.ones(nb, dtype=np.int32)
    dof2blocks: list[list[int]] = [[] for _ in range(ndof)]
    for i, b in enumerate(blocks):
        for d in b:
            dof2blocks[d].append(i)
    adj: list[set] = [set() for _ in range(nb)]
    for row in eldofs:
        touch: set = set()
        for d in row:
            touch.update(dof2blocks[d])
        for i in touch:
            adj[i].update(touch)

    degs = np.array([len(a) - (i in a) for i, a in enumerate(adj)])
    removed = np.zeros(nb, bool)
    order: list[int] = []
    h = [(int(degs[i]), i) for i in range(nb)]
    heapq.heapify(h)
    while h:
        d, i = heapq.heappop(h)
        if removed[i] or d != degs[i]:
            continue
        removed[i] = True
        order.append(i)
        for j in adj[i]:
            if not removed[j] and j != i:
                degs[j] -= 1
                heapq.heappush(h, (int(degs[j]), j))
    for i in reversed(order):
        taken = {colors[j] for j in adj[i] if colors[j] >= 0}
        c = 0
        while c in taken:
            c += 1
        colors[i] = c
    return colors


class MulticolorGS:
    """Forward/backward multi-color block-GS sweeps over precomputed dense
    block inverses.

    ``dofs``: (nblocks, bmax) padded with -1; ``mats``: the matching dense
    blocks (padding rows/cols identity), inverted on the host in f64 and
    stored in ``dtype`` on ``device``.  Each color step costs one operator
    apply and one batched block solve, through
    :func:`~navier_stokes_tpu_torch.ops.local_mv.batched_local_matvec` (the
    hand-written kernel on the card, f32 or f64)."""

    def __init__(self, dofs: np.ndarray, mats: np.ndarray,
                 colors: np.ndarray, ndof: int, dtype=torch.float64,
                 device=None):
        device = resolve_device(device)
        self.ndof = ndof
        self.ncolors = int(colors.max()) + 1
        inv = np.linalg.inv(np.asarray(mats, np.float64))
        self.groups = []
        for c in range(self.ncolors):
            sel = np.where(colors == c)[0]
            d = np.asarray(dofs[sel], np.int64)
            pad = d < 0
            self.groups.append((
                torch.as_tensor(np.where(pad, 0, d), device=device),
                torch.as_tensor(pad, device=device),
                torch.as_tensor(inv[sel], device=device).to(dtype)
                .contiguous(),
                ScatterPlan(torch.as_tensor(d, device=device), ndof)))

    def _solve_color(self, g, r):
        safe, pad, inv, scatter = g
        rb = torch.where(pad, 0.0, r[safe])
        # same-color blocks are dof-disjoint: each dof takes one value
        return scatter(batched_local_matvec(inv, rb))

    def forward(self, A_apply, x, y):
        for g in self.groups:
            y = y + self._solve_color(g, x - A_apply(y))
        return y

    def backward(self, A_apply, x, y):
        for g in reversed(self.groups):
            y = y + self._solve_color(g, x - A_apply(y))
        return y


def symmetric_gs_preconditioner(gs: MulticolorGS, A_apply, coarse=None,
                                free=None):
    """MypreA.Mult with GS=True: forward block-GS, the additive coarse
    correction on the residual, backward block-GS.  Symmetric by
    construction (reverse color order, exact coarse).  ``free``: a bool
    mask; constrained entries pass through unchanged.  ``preA.gs`` is
    ``gs``."""

    def preA(x):
        xf = torch.where(free, x, 0.0) if free is not None else x
        y = gs.forward(A_apply, xf, torch.zeros_like(xf))
        if coarse is not None:
            y = y + coarse(xf - A_apply(y))
        y = gs.backward(A_apply, xf, y)
        return torch.where(free, y, x) if free is not None else y

    preA.gs = gs
    return preA


def damped_coarse(coarse, A_apply, example: torch.Tensor,
                  target: float = 0.9, iters: int = 30, group=None):
    """Scale an auxiliary-space coarse correction for multiplicative use.

    Inside the symmetric sweep the correction ``y += C (x - A y)`` keeps the
    preconditioner positive definite only when lambda_max(C A) < 2.  A
    power iteration of ``iters`` steps from ``example`` estimates
    lambda_max(C A), and C is scaled to ``target`` (the JAX package's
    default 0.9; bench.py passes 1.6; it must stay below 2).  ``group``:
    the vectors are each rank's block of a vector split over a process
    group, whose norms sum over it (``linalg/pytree.tnorm``).  Returns
    (damped coarse, lambda, theta)."""
    if group is None:
        norm = torch.linalg.vector_norm
    else:
        def norm(x):
            return tnorm(x, group)
    v = example / norm(example)
    lam_t = torch.ones((), dtype=v.dtype)
    for _ in range(iters):
        w = coarse(A_apply(v))
        lam_t = norm(w)
        v = w / torch.clamp(lam_t, min=1e-30)
    lam = float(lam_t)
    theta = min(1.0, target / max(lam, 1e-30))
    if not np.isfinite(theta) or theta <= 0:
        theta = 1.0

    def coarse_damped(r):
        return theta * coarse(r)

    return coarse_damped, lam, theta

"""Multi-color block Gauss-Seidel support: coloring and coarse damping.

Counterpart of ``color_blocks`` (element-clique branch) and
``damped_coarse`` in ``navier_stokes_tpu/precond/multicolor.py``.  The
symmetric multicolor sweep itself lives with the face-block smoother
(ops/faceblock.FaceStarSmoother.solve_color_rows) and the skeleton
preconditioner (models/auxspace3d.py).
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

__all__ = ["color_blocks", "damped_coarse"]


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


def damped_coarse(coarse, A_apply, example: torch.Tensor, target: float,
                  iters: int = 30):
    """Scale an auxiliary-space coarse correction for multiplicative use.

    Inside the symmetric sweep the correction ``y += C (x - A y)`` keeps the
    preconditioner positive definite only when lambda_max(C A) < 2.  A
    power iteration of ``iters`` steps from ``example`` estimates
    lambda_max(C A), and C is scaled to ``target`` (bench.py passes 1.6;
    it must stay below 2).  Returns (damped coarse, lambda, theta)."""
    v = example / torch.linalg.vector_norm(example)
    lam_t = torch.ones((), dtype=v.dtype)
    for _ in range(iters):
        w = coarse(A_apply(v))
        lam_t = torch.linalg.vector_norm(w)
        v = w / torch.clamp(lam_t, min=1e-30)
    lam = float(lam_t)
    theta = min(1.0, target / max(lam, 1e-30))
    if not np.isfinite(theta) or theta <= 0:
        theta = 1.0

    def coarse_damped(r):
        return theta * coarse(r)

    return coarse_damped, lam, theta

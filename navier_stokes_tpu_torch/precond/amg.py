"""Smoothed-aggregation AMG for P1 operators: the coarse solve of the
auxiliary-space preconditioners above ``dense_limit`` free vertices.

Counterpart of ``navier_stokes_tpu/precond/amg.py``:

* setup (host, scipy.sparse), copied with its seeds so that both packages
  build the same hierarchy from the same matrix: strength-based aggregation
  by seeded Luby rounds, tentative piecewise-constant prolongation,
  Jacobi-smoothed P, Galerkin coarse operators, recursing until the coarsest
  level is small enough for a dense inverse -- memory O(nnz) = O(nv);
* apply (torch on ``device``): a symmetric V-cycle with degree-2 Chebyshev
  smoothing.  Every level's operator and prolongation is stored in padded
  ELL form, so an SpMV is one gather and one row sum (plain PyTorch: the JAX
  package computes it outside any Pallas kernel as well).

The V-cycle with matched pre/post Chebyshev smoothing is symmetric and
positive definite, as the Krylov solvers require.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device

__all__ = ["build_sa_amg"]


def _ell(A: sp.spmatrix, dtype, device):
    """Padded ELL tables (idx (n, w) int32, val (n, w)) of a csr matrix,
    vectorized over the nonzeros."""
    A = A.tocsr()
    n = A.shape[0]
    counts = np.diff(A.indptr)
    width = max(int(counts.max()) if n else 1, 1)
    idx = np.zeros((n, width), dtype=np.int32)
    val = np.zeros((n, width))
    rows = np.repeat(np.arange(n), counts)
    slots = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    idx[rows, slots] = A.indices
    val[rows, slots] = A.data
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(val, device=device).to(dtype))


def _ell_apply(idx, val, x):
    """y = A x for x of shape (n,) or (n, k): gather, multiply, row sum."""
    g = x[idx]  # (n, w) or (n, w, k)
    if x.dim() == 2:
        return (val[:, :, None] * g).sum(dim=1)
    return (val * g).sum(dim=1)


def _aggregate(A: sp.csr_matrix) -> np.ndarray:
    """Strength-based aggregation; returns the aggregate id per row.

    Pass 1 seeds aggregates by Luby-style rounds: a vertex seeds when its
    random priority beats every other still-candidate vertex within
    distance 2 of the strong graph, each round two ``np.minimum.at`` edge
    reductions; pass 2 attaches each leftover to its strongest strong
    neighbor among the pass-1 aggregates, remaining isolates become
    singletons."""
    n = A.shape[0]
    d = np.sqrt(np.maximum(A.diagonal(), 1e-300))
    theta = 0.08  # strong: |a_ij| >= theta sqrt(a_ii a_jj)
    coo = A.tocoo()
    strong = (coo.row != coo.col) & (
        np.abs(coo.data) >= theta * d[coo.row] * d[coo.col]
    )
    srow, scol = coo.row[strong], coo.col[strong]
    sdata = np.abs(coo.data[strong])
    agg = -np.ones(n, dtype=np.int64)
    n_agg = 0
    # seeded priorities: reproducible, and O(log n) rounds on any numbering
    prio = np.random.default_rng(0).permutation(n).astype(np.float64)
    INF = np.float64(np.inf)
    has_nbr_assigned = np.zeros(n, bool)
    for _round in range(10000):
        cand = (agg < 0) & ~has_nbr_assigned
        if not cand.any():
            break
        v = np.where(cand, prio, INF)
        m1 = v.copy()
        np.minimum.at(m1, srow, v[scol])
        m2 = v.copy()
        np.minimum.at(m2, srow, m1[scol])
        win = cand & (m2 == prio)
        seeds = np.where(win)[0]
        agg[seeds] = n_agg + np.arange(len(seeds))
        n_agg += len(seeds)
        member_edge = win[srow] & (agg[scol] < 0)
        agg[scol[member_edge]] = agg[srow[member_edge]]
        np.logical_or.at(has_nbr_assigned, srow, agg[scol] >= 0)
    left = agg < 0
    if left.any():
        edge_ok = left[srow] & (agg[scol] >= 0)
        er, ev, ec = srow[edge_ok], sdata[edge_ok], scol[edge_ok]
        best_w = np.zeros(n)
        np.maximum.at(best_w, er, ev)
        hit = ev >= best_w[er] * (1.0 - 1e-12)
        agg_best = -np.ones(n, dtype=np.int64)
        agg_best[er[hit]] = agg[ec[hit]]
        attach = left & (agg_best >= 0)
        agg[attach] = agg_best[attach]
        isolates = np.where(agg < 0)[0]
        agg[isolates] = n_agg + np.arange(len(isolates))
    return agg


@dataclass
class _Level:
    A_idx: torch.Tensor
    A_val: torch.Tensor
    P_idx: torch.Tensor  # prolongation rows (fine)
    P_val: torch.Tensor
    R_idx: torch.Tensor  # restriction rows (coarse)
    R_val: torch.Tensor
    diag_inv: torch.Tensor
    lam_max: float


def build_sa_amg(K: sp.spmatrix, free: np.ndarray, dtype=torch.float64,
                 device=None, coarse_size: int = 600, max_levels: int = 6,
                 omega: float = 0.66, cheb_degree: int = 2):
    """Symmetric SA-AMG V-cycle preconditioner for ``K`` on the free dofs.

    Returns apply(r) -> z acting on full-length vectors (n,) or (n, k), zero
    on constrained dofs.  Memory is O(nnz) across levels.  ``apply.levels``
    holds the number of ELL levels above the dense coarsest one."""
    device = resolve_device(device)
    free_idx = np.where(free)[0]
    n0 = K.shape[0]
    A = K.tocsr()[free_idx][:, free_idx].tocsr()
    levels: list[_Level] = []
    while A.shape[0] > coarse_size and len(levels) < max_levels:
        agg = _aggregate(A)
        n_agg = int(agg.max()) + 1
        P_t = sp.csr_matrix(
            (np.ones(A.shape[0]), (np.arange(A.shape[0]), agg)),
            shape=(A.shape[0], n_agg),
        )
        Dinv = sp.diags(1.0 / np.maximum(A.diagonal(), 1e-300))
        # smoothed prolongation: (I - omega / lam D^-1 A) P_t
        lam = _power_lam(A, Dinv)
        P = (sp.eye(A.shape[0]) - (omega / lam) * (Dinv @ A)) @ P_t
        P = P.tocsr()
        A_c = (P.T @ A @ P).tocsr()
        Ai, Av = _ell(A, dtype, device)
        Pi, Pv = _ell(P, dtype, device)
        Ri, Rv = _ell(P.T.tocsr(), dtype, device)
        diag_inv = torch.as_tensor(1.0 / np.maximum(A.diagonal(), 1e-300),
                                   device=device).to(dtype)
        levels.append(_Level(Ai, Av, Pi, Pv, Ri, Rv, diag_inv, float(lam)))
        A = A_c
    coarse_inv = torch.as_tensor(
        np.linalg.inv(A.todense() + 1e-30 * np.eye(A.shape[0])),
        device=device).to(dtype)
    free_t = torch.as_tensor(free_idx, device=device)

    def scale(d, v):  # d (n,) times v (n,) or (n, k)
        return d[:, None] * v if v.dim() == 2 else d * v

    def cheb_smooth(lv: _Level, r, z):
        """Degree-``cheb_degree`` Chebyshev iteration on D^-1 A targeting
        [0.3, 1.1] * lam_max (the same fixed polynomial in D^-1 A pre and
        post, so the V-cycle stays SPD)."""
        lo, hi = 0.3 * lv.lam_max, 1.1 * lv.lam_max
        theta, delta = 0.5 * (hi + lo), 0.5 * (hi - lo)
        sigma1 = theta / delta
        res = r - _ell_apply(lv.A_idx, lv.A_val, z)
        d = scale(lv.diag_inv, res) / theta
        z = z + d
        rho_old = 1.0 / sigma1
        for _ in range(cheb_degree - 1):
            rho = 1.0 / (2.0 * sigma1 - rho_old)
            res = r - _ell_apply(lv.A_idx, lv.A_val, z)
            d = rho * rho_old * d + (2.0 * rho / delta) * scale(lv.diag_inv,
                                                                res)
            z = z + d
            rho_old = rho
        return z

    def vcycle(lv_i: int, r):
        if lv_i == len(levels):
            return coarse_inv @ r
        lv = levels[lv_i]
        z = cheb_smooth(lv, r, torch.zeros_like(r))
        res = r - _ell_apply(lv.A_idx, lv.A_val, z)
        rc = _ell_apply(lv.R_idx, lv.R_val, res)
        zc = vcycle(lv_i + 1, rc)
        z = z + _ell_apply(lv.P_idx, lv.P_val, zc)
        return cheb_smooth(lv, r, z)

    def apply(r):
        out = r.new_zeros((n0,) + tuple(r.shape[1:]))
        out[free_t] = vcycle(0, r[free_t])
        return out

    apply.levels = len(levels)
    return apply


def _power_lam(A: sp.csr_matrix, Dinv: sp.spmatrix, iters: int = 20) -> float:
    rng = np.random.default_rng(0)
    v = rng.standard_normal(A.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    DA = Dinv @ A
    for _ in range(iters):
        w = DA @ v
        lam = np.linalg.norm(w)
        v = w / max(lam, 1e-30)
    return float(max(lam, 1e-12))

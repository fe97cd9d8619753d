"""Plain operators and solvers of the reference: element tables applied by
one batched product and one ``index_add_``, preconditioned conjugate
gradients, the Lanczos estimate of a largest eigenvalue and the Chebyshev
polynomial of the transient step's mass inverse.

Every routine takes its precision from the tensors it is given, so that the
same code computes the reference in float64 and its control in bfloat16
(inner products are then summed in float32).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["ElementOp", "cg", "lanczos_max", "chebyshev_inverse"]


class ElementOp:
    """y = sum_e P_rows(e)^T T[e] x[cols(e)]: the (ne, r, c) element table
    ``table`` between the global vectors of length ``n_cols`` (input) and
    ``n_rows`` (output)."""

    def __init__(self, table, rows, cols, n_rows: int, dtype, device):
        self.table = torch.as_tensor(np.ascontiguousarray(table),
                                     device=device).to(dtype)
        self.rows = torch.as_tensor(np.asarray(rows, np.int64),
                                    device=device).reshape(-1)
        self.cols = torch.as_tensor(np.asarray(cols, np.int64),
                                    device=device)
        self.n_rows = n_rows

    def __call__(self, x):
        xe = x[self.cols].to(self.table.dtype)
        ye = torch.bmm(self.table, xe[:, :, None])
        return ye.new_zeros(self.n_rows).index_add_(0, self.rows,
                                                    ye.reshape(-1))


def _dot(a, b):
    if a.dtype in (torch.float16, torch.bfloat16):
        return torch.dot(a.float(), b.float())
    return torch.dot(a, b)


def cg(A, b, pre, tol: float, maxsteps: int):
    """Preconditioned CG from x = 0 until sqrt(r.z) <= tol * sqrt(r0.z0).
    Returns (x, iterations)."""
    x = torch.zeros_like(b)
    r = b
    z = pre(r)
    rho = _dot(r, z)
    err0 = math.sqrt(abs(float(rho)))
    p = z
    it = 0
    while math.sqrt(abs(float(rho))) > tol * err0 and it < maxsteps:
        q = A(p)
        alpha = rho / _dot(p, q)
        x = x + (alpha * p).to(x.dtype)
        r = r - (alpha * q).to(r.dtype)
        z = pre(r)
        rho_new = _dot(r, z)
        p = z + ((rho_new / rho) * p).to(z.dtype)
        rho = rho_new
        it += 1
    return x, it


def lanczos_max(A, pre, n: int, iterations: int, v0, dtype, device) -> float:
    """Largest Ritz value of pre A (A, pre SPD) after ``iterations`` steps of
    Lanczos in the pre^-1 inner product from ``v0``, with full
    reorthogonalization (two passes)."""
    z0 = v0.to(device=device, dtype=dtype)
    p0 = pre(z0)
    beta0 = torch.sqrt(torch.abs(torch.dot(z0, p0)))
    V = torch.zeros((iterations, n), dtype=dtype, device=device)
    Z = torch.zeros((iterations, n), dtype=dtype, device=device)
    V[0], Z[0] = p0 / beta0, z0 / beta0
    diag = np.zeros(iterations)
    offd = np.zeros(iterations)
    for j in range(iterations):
        v = V[j]
        w = A(v)
        alpha = float(torch.dot(v, w))
        for _ in range(2):
            w = w - Z.T @ (V @ w)
        v_new = pre(w)
        beta = float(torch.sqrt(torch.abs(torch.dot(w, v_new))))
        diag[j] = alpha
        if beta < 1e-10 * (abs(alpha) + 1.0):
            continue
        offd[j] = beta
        if j + 1 < iterations:
            V[j + 1] = v_new / beta
            Z[j + 1] = w / beta
    T = (np.diag(diag) + np.diag(offd[:-1], 1) + np.diag(offd[:-1], -1))
    return float(np.linalg.eigvalsh(T).max())


def chebyshev_inverse(A, pre, alpha: float, beta: float, degree: int):
    """The degree-``degree`` Chebyshev polynomial in pre A on [alpha, beta]
    that approximates A^-1: a fixed linear operator."""
    theta = 0.5 * (beta + alpha)
    delta = 0.5 * (beta - alpha)
    sigma1 = theta / delta

    def apply(b):
        pb = pre(b)
        rho_prev = 1.0 / sigma1
        d = (1.0 / theta) * pb
        z = d
        for _ in range(degree - 1):
            r = pb - pre(A(z))
            rho = 1.0 / (2.0 * sigma1 - rho_prev)
            d = (2.0 * rho / delta) * r + (rho * rho_prev) * d
            z = d + z
            rho_prev = rho
        return z

    return apply

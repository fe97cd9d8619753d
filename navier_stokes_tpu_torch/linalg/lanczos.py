"""Preconditioned Lanczos eigenvalue estimation.

Counterpart of ``navier_stokes_tpu/linalg/lanczos.py``: Ritz values of
pre @ A (equivalently of A in the pre^{-1} inner product) for the Chebyshev
bounds of the transient step's mass inverse, and the condition estimate of
pre @ A built on them.

Full reorthogonalization is essential: the plain three-term recurrence loses
orthogonality once Ritz values converge and can report spurious (even
negative) lambda_min.  The basis is kept in two (m, n) buffers so each
reorthogonalization is two dense products, done twice ("twice is enough").
These products run in the vectors' own precision: the port leaves
``torch.backends.cuda.matmul.allow_tf32`` off, and an f32 run with TF32
products would lose the orthogonality (and the Ritz values with it).

The loop runs on the host (setup code, a few tens of iterations) with the
vector work on the vectors' device.  The start vector is the port's own
draw: ``jax.random.PRNGKey(0)`` cannot be reproduced, so pass ``v0`` where
a run must be repeatable against other data.  Under a profiler the call
is the span ``lanczos`` around ``lanczos.apply``, ``lanczos.pre`` and the
two ``lanczos.read`` spans of each step (``utils/tracing.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tracing import traced, wrap

__all__ = ["lanczos_eigenvalues", "condition_estimate"]


@traced("lanczos")
def lanczos_eigenvalues(A, pre, example_vec: torch.Tensor,
                        iterations: int = 40,
                        v0: torch.Tensor | None = None,
                        group=None) -> np.ndarray:
    """Ritz values (ascending, numpy) of pre @ A for SPD A and SPD pre.

    ``A``/``pre`` are callables on tensors shaped like ``example_vec``,
    which fixes shape, dtype and device.  ``v0``: the start vector;
    otherwise standard normal numbers drawn on the CPU from a generator
    seeded with 0, so that the draw does not depend on the device.
    min/max are sharp after about 30-40 iterations.  ``group``: the
    vectors are each rank's block of vectors split over a process group
    (``linalg/pytree.tdot``); every inner product is summed over it."""
    shape, dtype, dev = example_vec.shape, example_vec.dtype, example_vec.device
    n = example_vec.numel()
    m = iterations

    def Af(x):
        return A(x.reshape(shape)).reshape(-1)

    def pref(x):
        return pre(x.reshape(shape)).reshape(-1)

    def reduce(t):
        return t if group is None else group.all_reduce(t)

    Af, pref, read = (wrap("lanczos.apply", Af), wrap("lanczos.pre", pref),
                      wrap("lanczos.read", float))

    if v0 is None:
        v0 = torch.randn(n, generator=torch.Generator().manual_seed(0),
                         dtype=torch.float64)
    z0 = v0.reshape(-1).to(device=dev, dtype=dtype)
    p0 = pref(z0)
    beta0 = torch.sqrt(torch.abs(reduce(torch.dot(z0, p0))))
    v = p0 / beta0
    z = z0 / beta0  # z = pre^{-1} v ; <v_i, v_j>_B = v_i . z_j = delta_ij

    Vb = torch.zeros((m, n), dtype=dtype, device=dev)
    Zb = torch.zeros((m, n), dtype=dtype, device=dev)
    Vb[0], Zb[0] = v, z
    diag = np.zeros(m)
    offd = np.zeros(m)
    for j in range(m):
        v = Vb[j]
        w = Af(v)
        alpha = read(reduce(torch.dot(v, w)))
        # full reorthogonalization in the dual: w -= Z^T (V w); rows past j
        # are zero so they contribute nothing.  Two passes.
        for _ in range(2):
            w = w - Zb.T @ reduce(Vb @ w)
        v_new = pref(w)
        beta = read(torch.sqrt(torch.abs(reduce(torch.dot(w, v_new)))))
        diag[j] = alpha
        if beta < 1e-10 * (abs(alpha) + 1.0):  # breakdown: keep offd[j] = 0
            continue
        offd[j] = beta
        if j + 1 < m:
            Vb[j + 1] = v_new / beta
            Zb[j + 1] = w / beta

    T = np.diag(diag) + np.diag(offd[: m - 1], 1) + np.diag(offd[: m - 1], -1)
    return np.linalg.eigvalsh(T)


def condition_estimate(A, pre, example_vec: torch.Tensor,
                       iterations: int = 40,
                       v0: torch.Tensor | None = None
                       ) -> tuple[float, float, float]:
    """(lambda_min, lambda_max, cond) of pre @ A from
    :func:`lanczos_eigenvalues` (the same start vector: ``v0`` or the
    port's seeded draw)."""
    lams = lanczos_eigenvalues(A, pre, example_vec, iterations, v0)
    lmin, lmax = float(lams.min()), float(lams.max())
    return lmin, lmax, lmax / lmin

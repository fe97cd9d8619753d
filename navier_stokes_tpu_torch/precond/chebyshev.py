"""Chebyshev polynomial preconditioner / smoother.

Counterpart of ``navier_stokes_tpu/precond/chebyshev.py``: a fixed-degree
Chebyshev polynomial in a base SPD smoother (Jacobi) is a LINEAR, SPD
operator built purely from operator applies -- the fixed-degree
approximation of the velocity mass inverse inside the transient step's
projection.  The apply needs no host read.

Spectral bounds come from the Lanczos estimator (linalg/lanczos.py) unless
``bounds`` is given.  Under a profiler each apply is the span
``chebyshev`` (``utils/tracing.py``).
"""

from __future__ import annotations

from ..linalg.lanczos import lanczos_eigenvalues
from ..utils.tracing import traced

__all__ = ["chebyshev_preconditioner"]


def chebyshev_preconditioner(A, base_pre, example_vec, degree: int = 4,
                             bounds: tuple[float, float] | None = None,
                             lanczos_iterations: int = 30,
                             lower_fraction: float = 0.1):
    """Chebyshev acceleration of ``base_pre`` for the SPD operator ``A``.

    Approximates A^{-1} by the degree-``degree`` Chebyshev polynomial of
    (base_pre A) on [alpha, beta]; with ``bounds`` unset, beta is the
    Lanczos lambda_max estimate (x1.05 safety) and alpha =
    ``lower_fraction`` * beta.  Returns a linear SPD apply with
    ``apply.bounds`` = (alpha, beta)."""
    if bounds is None:
        lams = lanczos_eigenvalues(A, base_pre, example_vec,
                                   lanczos_iterations)
        beta = 1.05 * float(lams.max())
        alpha = lower_fraction * beta
    else:
        alpha, beta = (float(b) for b in bounds)

    theta = 0.5 * (beta + alpha)
    delta = 0.5 * (beta - alpha)
    sigma1 = theta / delta

    @traced("chebyshev")
    def apply(b):
        # standard Chebyshev iteration for M z = b with M = (base_pre A)
        # preconditioned by base_pre; z accumulates the polynomial in
        # base_pre*A applied to base_pre*b
        pb = base_pre(b)
        rho = 1.0 / sigma1
        d = (1.0 / theta) * pb
        z = d
        rho_prev = rho
        for _ in range(degree - 1):
            r = pb - base_pre(A(z))
            rho = 1.0 / (2.0 * sigma1 - rho_prev)
            d = (2.0 * rho / delta) * r + (rho * rho_prev) * d
            z = d + z
            rho_prev = rho
        return z

    apply.bounds = (alpha, beta)
    return apply

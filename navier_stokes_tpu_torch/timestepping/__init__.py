from .exponential import krylov_exponential_step
from .orthonormalization import orthonormalize
from .runge_kutta import (
    RungeKuttaWeights,
    implicit_runge_kutta_weights,
    linear_implicit_runge_kutta_step,
)

__all__ = ["RungeKuttaWeights", "implicit_runge_kutta_weights",
           "krylov_exponential_step", "linear_implicit_runge_kutta_step",
           "orthonormalize"]

from .quadrature import simplex_rule
from .spaces import (
    H1,
    L2,
    FunctionSpace,
    H1_with_bubble,
    Nonconforming,
    VectorH1,
    VectorSpace,
)

__all__ = ["FunctionSpace", "H1", "H1_with_bubble", "L2", "Nonconforming",
           "VectorH1", "VectorSpace", "simplex_rule"]

from .quadrature import simplex_rule
from .spaces import H1, L2, FunctionSpace, VectorH1, VectorSpace

__all__ = ["FunctionSpace", "H1", "L2", "VectorH1", "VectorSpace",
           "simplex_rule"]

from .quadrature import simplex_rule
from .spaces import H1, L2, FunctionSpace

__all__ = ["FunctionSpace", "H1", "L2", "simplex_rule"]

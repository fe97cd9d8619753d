from .lanczos import lanczos_eigenvalues
from .pytree import tadd, taxpy, tdot, tscale, tsub, tzeros_like

__all__ = ["lanczos_eigenvalues", "tadd", "taxpy", "tdot", "tscale", "tsub",
           "tzeros_like"]

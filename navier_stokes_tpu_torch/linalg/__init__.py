from .lanczos import condition_estimate, lanczos_eigenvalues
from .pytree import tadd, taxpy, tdot, tmask, tnorm, tscale, tsub, tzeros_like

__all__ = ["condition_estimate", "lanczos_eigenvalues", "tadd", "taxpy",
           "tdot", "tmask", "tnorm", "tscale", "tsub", "tzeros_like"]

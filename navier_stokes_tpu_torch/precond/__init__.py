from .twolevel import coarse_p1_solver

__all__ = ["coarse_p1_solver"]

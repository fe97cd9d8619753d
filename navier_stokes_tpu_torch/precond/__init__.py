from .amg import build_sa_amg
from .jacobi import block_jacobi
from .twolevel import (
    coarse_p1_solver,
    p1_embedding,
    two_level_preconditioner,
    vertex_patch_blocks,
)

__all__ = ["build_sa_amg", "block_jacobi", "coarse_p1_solver",
           "p1_embedding", "two_level_preconditioner", "vertex_patch_blocks"]

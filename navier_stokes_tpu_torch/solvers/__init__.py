"""Krylov solvers and refinement operators of the flagship solve."""

"""The equilibrated case of tests/test_torch_skeleton_slow.py (its
fixtures and tolerance): the port's dof-level additive skeleton
preconditioner of A~ = D A D with ``dof_scale=D`` (the coarse transfer
D^{-1} T) against the JAX package's, 1e-7 relative.
"""

from test_torch_skeleton_slow import (  # noqa: F401  (fixtures)
    check_against_jax,
    one_torch_thread,
    pair,
)


def test_slow_path_dof_scale_matches_jax_slow_path(pair):
    check_against_jax(pair, gs=False, scaled=True)

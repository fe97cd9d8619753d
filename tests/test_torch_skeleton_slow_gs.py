"""The GS cases of tests/test_torch_skeleton_slow.py (its fixtures and
tolerances): the port's dof-level multicolor GS skeleton preconditioner
against the JAX package's (1e-7 relative), and against the port's own
fast path (a relative gap under 0.5; symmetry to 1e-8 of the product's
size, as tests/test_skeleton_fast.py:50-61).
"""

import numpy as np
import pytest
import torch

from test_torch_skeleton_slow import (  # noqa: F401  (fixtures)
    F64,
    _port,
    _rel,
    check_against_jax,
    one_torch_thread,
    pair,
)


def test_slow_path_gs_matches_jax_slow_path(pair):
    check_against_jax(pair, gs=True)


def test_slow_path_gs_tables(pair):
    parts = _port(pair, True, False).parts
    tabs = parts["tables"]
    ne = pair["mp"].mesh.ne
    assert tabs["S"].shape[0] == ne and tabs["S"].dtype == F64
    ncolors = int(parts["colors"].max()) + 1
    assert {f"GS color {c} inverses" for c in range(ncolors)} <= set(tabs)
    assert 0 < parts["coarse_theta"] <= 1.0


@pytest.mark.parametrize("fast", [True, False])
def test_gs_fast_near_slow_and_symmetric(pair, fast):
    mp = pair["mp"]
    x = torch.as_tensor(pair["x"])
    pre = _port(pair, True, fast)
    if fast:
        rel = _rel(pre(x), _port(pair, True, False)(x))
        assert rel < 0.5, f"GS fast vs slow: {rel:.3e}"
    rng = np.random.default_rng(8)
    a = x * mp.free
    b = torch.as_tensor(rng.standard_normal(mp.n)) * mp.free
    lhs = float(torch.dot(pre(a), b))
    rhs = float(torch.dot(a, pre(b)))
    assert abs(lhs - rhs) < 1e-8 * max(abs(lhs), 1.0)

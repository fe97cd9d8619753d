"""The port's deterministic scatter-add (``ops.assembly.ScatterPlan``)
against ``index_add_``, on the CPU.

Held to: the plan's sum equal to ``index_add_``'s to rounding (1e-15
relative, f64), two calls bitwise equal, dropped (-1) entries, entries of
multiplicity one, destinations nothing lands on (zero), and every site
that used ``index_add_`` (the convection, block Jacobi, the multicolor GS
color solve, the P1 embedding and the MCS coarse transfer) routed through
plans, so that no float ``index_add_`` is left on the port's paths.
"""

import pathlib

import numpy as np
import pytest
import torch

from navier_stokes_tpu_torch.ops.assembly import (
    ScatterPlan,
    apply_local_matrices,
    scatter_add,
)

PORT = pathlib.Path(__file__).resolve().parent.parent / "navier_stokes_tpu_torch"


def _index_add(values, index, ndof):
    keep = index.reshape(-1) >= 0
    return values.new_zeros(ndof).index_add_(
        0, index.reshape(-1)[keep], values.reshape(-1)[keep])


@pytest.mark.parametrize("shape,ndof,hi", [
    ((40, 7), 120, 100),   # rows 100..119 receive nothing
    ((1, 1), 3, 1),        # one entry
    ((300,), 300, 300),    # a permutation-like table: multiplicities <= ~6
    ((25, 13), 9, 9),      # heavy multiplicity
])
def test_scatter_plan_equals_index_add(shape, ndof, hi):
    rng = np.random.default_rng(sum(shape) + ndof)
    index = torch.from_numpy(rng.integers(0, hi, size=shape))
    values = torch.from_numpy(rng.standard_normal(shape))
    plan = ScatterPlan(index, ndof)
    got = plan(values)
    want = _index_add(values, index, ndof)
    scale = float(torch.abs(values).sum())
    assert float((got - want).abs().max()) <= 1e-15 * scale
    if hi < ndof:
        assert bool((got[hi:] == 0).all())
    assert torch.equal(got, plan(values.clone()))  # bitwise repeatable
    assert torch.equal(got, scatter_add(values, index, ndof))


def test_scatter_plan_multiplicity_one_is_a_permutation():
    rng = np.random.default_rng(3)
    perm = torch.from_numpy(rng.permutation(50))
    values = torch.from_numpy(rng.standard_normal(50))
    plan = ScatterPlan(perm, 50)
    assert plan.width == 1
    out = plan(values)
    assert torch.equal(out[perm], values)


def test_scatter_plan_drops_negative_entries_and_keeps_order():
    index = torch.tensor([[2, -1, 0], [2, 2, -1]])
    values = torch.tensor([[1.0, 100.0, 5.0], [1e-17, 1.0, 7.0]],
                          dtype=torch.float64)
    plan = ScatterPlan(index, 4)
    assert plan.width == 3
    out = plan(values)
    assert out.tolist() == [5.0, 0.0, 2.0, 0.0]
    # the plan lists each destination's entries in their original order
    np.testing.assert_array_equal(plan.table[2].numpy(), [0, 3, 4])


def test_scatter_plan_refuses_bad_input():
    with pytest.raises(ValueError):
        ScatterPlan(torch.tensor([0, 5]), 5)
    plan = ScatterPlan(torch.tensor([[0, 1]]), 2)
    with pytest.raises(ValueError):
        plan(torch.zeros(3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_apply_local_matrices_through_a_plan(dtype):
    rng = np.random.default_rng(5)
    ne, nb, ndof = 30, 6, 70
    eld = torch.from_numpy(rng.integers(0, ndof, size=(ne, nb)))
    a = torch.from_numpy(rng.standard_normal((ne, nb, nb))).to(dtype)
    u = torch.from_numpy(rng.standard_normal(ndof)).to(dtype)
    plan = ScatterPlan(eld, ndof)
    y_plan = apply_local_matrices(a, plan, ndof, u, use_kernel=True)
    y_index = apply_local_matrices(a, eld, ndof, u)
    assert torch.equal(y_plan, y_index)
    want = _index_add(torch.einsum("eij,ej->ei", a, u[eld]), eld, ndof)
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    assert float((y_plan - want).abs().max()) <= tol * float(
        want.abs().max())


def test_no_float_index_add_left_in_the_port():
    """Every scatter of the port goes through ScatterPlan."""
    hits = [f"{p.relative_to(PORT)}:{i}"
            for p in sorted(PORT.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if ".index_add_(" in line or ".scatter_add_(" in line
            or "index_put_" in line]
    assert hits == []

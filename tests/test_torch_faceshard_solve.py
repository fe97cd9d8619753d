"""The face-sharded production solve (``navier_stokes_tpu_torch.parallel.
faceshard.sharded_fast_flagship_solve``) on 2 gloo ranks against the JAX
package's on 2 devices.

The straight 3D channel with cylinder at maxh 0.6 (tests/test_faceshard.py's
model), the multicolor GS sweep, ``two_phase=False`` (the f32 MINRES
refinement driver with the deep-tolerance ``abs_test``), tol and inner_tol
1e-2: on one CPU thread per rank an inner iteration takes 0.2-0.4 s (the
gloo exchanges slow down with the machine's load), so the JAX test's 1e-6
(622 inner iterations) does not fit this file's minute; the card runs
the solve to 1e-6 and the 2-phase one to 1e-8 (``chip_smoke.py``
``[shard]``).  The JAX figures come from ``tools/jax_faceshard_reference.py
--face-runs cpu-test --save`` (105 inner iterations in one pass to
2.24e-3; its solution, in float32, in ``tools/jax_faceshard_x.npz``; the
JAX sharded solve takes about 110 s on the CPU).  Bounds: the inner count
within JAX's rule, |d| <= max(10, 0.1 n), of JAX's; the same passes; the
velocity within 2e-3 of the largest entry of JAX's (the JAX test's bound
for a sharded solution; 2.4e-4 read); the true f64 relative residual,
through the model's plain f64 operators, at most tol.
"""

import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from navier_stokes_tpu_torch.flagship import build_model
from navier_stokes_tpu_torch.parallel import faceshard, sharding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SOLUTION = os.path.join(ROOT, "tools", "jax_faceshard_x.npz")
MAXH = 0.6
KW = dict(tol=1e-2, inner_tol=1e-2, inner_maxsteps=800, gs=True,
          two_phase=False)
JAX = dict(inner=105, passes=1, rel=0.002235918365378824)


@pytest.fixture(scope="module")
def solved():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        m = build_model(MAXH, device="cpu", curved=False)
        out = faceshard.sharded_fast_flagship_solve(
            m, sharding.Ranks(2, device="cpu", threads=1), **KW)
    torch.set_num_threads(n)
    return m, out


def test_sharded_solve_matches_jax_count(solved):
    _, ((xu, xp), rel, passes, inner, plan) = solved
    assert rel <= KW["tol"]
    assert passes == JAX["passes"]
    assert abs(inner - JAX["inner"]) <= max(10, 0.1 * JAX["inner"]), inner
    stats = plan.run_stats
    # one inner iteration: 2 all_reduces of MINRES, halo exchanges of the
    # operators and the GS sweep
    assert stats["collectives"]["all_gather"] > 20 * inner
    assert stats["collectives"]["all_reduce"] >= 2 * inner


def test_sharded_solution_matches_jax_and_solves_the_system(solved):
    m, ((xu, xp), rel, passes, inner, plan) = solved
    ref = np.load(JAX_SOLUTION)
    scale = np.abs(ref["x_u"]).max()
    assert np.abs(xu - ref["x_u"]).max() <= 2e-3 * scale
    f = torch.where(m.free, m.f - m.A_raw(m.u_bc), 0.0)
    g = -m.B_raw(m.u_bc)
    u, p = torch.tensor(xu), torch.tensor(xp)
    r0 = f - m.A(u) - m.BT(p)
    r1 = g - m.B(u)
    true = float(torch.sqrt(r0 @ r0 + r1 @ r1) / torch.sqrt(f @ f + g @ g))
    assert true <= KW["tol"], true
    assert abs(true - rel) <= 1e-3 * rel

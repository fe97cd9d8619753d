"""The plain reference against the port's plain CPU path at a small size:
the same element tables, the same operators on the same vectors, a Stokes
state the port solved, and one SIMPLE step."""

import numpy as np
import pytest
import torch

from perfbench.reference.systems import (
    SimpleReference,
    StokesReference,
    hdg3d_host,
    inflow,
    mcs3d_host,
)

MAXH, NU, UM = 0.6, 1e-3, 0.8


def _program_uin(p):
    from navier_stokes_tpu_torch.flagship import uin

    return UM * uin(p)


@pytest.fixture(scope="module")
def mcs():
    from navier_stokes_tpu_torch.flagship import cylinder_geometry
    from navier_stokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_mesh_3d,
    )
    from navier_stokes_tpu_torch.models import NavierStokesMCS

    mesh = channel_with_cylinder_mesh_3d(MAXH)
    m = NavierStokesMCS(mesh, nu=NU, inflow="inlet", outflow="outlet",
                        wall="wall|cyl", uin=_program_uin, timestep=2e-3,
                        order=2, device="cpu",
                        geometry=cylinder_geometry(mesh))
    return m, mcs3d_host(MAXH, 2, NU, curved=True)


@pytest.fixture(scope="module")
def hdg():
    from navier_stokes_tpu_torch.mesh.generators import (
        channel_with_cylinder_mesh_3d,
    )
    from navier_stokes_tpu_torch.models import NavierStokesHDG3D

    mesh = channel_with_cylinder_mesh_3d(MAXH)
    m = NavierStokesHDG3D(mesh, nu=NU, inflow="inlet", outflow="outlet",
                          wall="wall|cyl", uin=_program_uin, timestep=2e-3,
                          order=2, device="cpu")
    return m, hdg3d_host(MAXH, 2, NU)


def test_inflow_is_the_programs(mcs):
    from navier_stokes_tpu_torch.flagship import uin

    p = np.random.default_rng(0).uniform(0, 0.41, (50, 3))
    np.testing.assert_allclose(inflow(UM)(p), UM * uin(p), rtol=1e-14)


def test_mcs_tables_and_operators(mcs):
    m, host = mcs
    np.testing.assert_allclose(host["A"], m.A_cond_np, rtol=0, atol=1e-10
                               * np.abs(m.A_cond_np).max())
    np.testing.assert_array_equal(host["M"], m._M_loc_np)
    np.testing.assert_array_equal(host["B"], m.B_loc_np)
    ref = StokesReference(host, UM)
    assert np.array_equal(ref.free.numpy(), m.free.numpy())
    np.testing.assert_allclose(ref.u_bc.numpy(), m.u_bc.numpy(), rtol=0,
                               atol=1e-15)
    x = torch.randn(m.n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    q = torch.randn(m.Q.ndof, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    for a, b in ((ref.A(x), m.A_raw(x)), (ref.B(x), m.B_raw(x)),
                 (torch.where(ref.free, ref.BT(q), 0.0), m.BT(q))):
        assert float((a - b).abs().max()) <= 1e-11 * float(b.abs().max())


def test_mcs_stokes_state_and_step(mcs):
    from navier_stokes_tpu_torch.flagship import FlagshipSolve

    m, host = mcs
    res = FlagshipSolve(m).full_solve()
    u0, p0 = m.u_bc + res.x[0], res.x[1]
    ref = SimpleReference(host, UM, 2e-3)
    rel = ref.true_rel(u0, p0)
    assert rel <= 1e-8
    assert abs(rel - res.true_rel) <= 1e-3 * res.true_rel + 1e-14
    # the port's f64 step, its CGs to a tight tolerance, against the
    # reference's step from the same state
    step = m.make_step_fn(project_tol=1e-11, mstar_tol=1e-11)
    alpha, beta = m._mass_chebyshev().bounds
    assert abs(beta - ref.beta) <= 1e-10 * beta
    assert abs(alpha - ref.alpha) <= 1e-10 * alpha
    u1 = step(u0)
    r1, _, _ = ref.step(u0)
    gap = float(torch.linalg.norm(u1 - r1) / torch.linalg.norm(r1 - u0))
    assert gap <= 1e-7


def test_hdg_tables_and_operators(hdg):
    m, host = hdg
    np.testing.assert_allclose(host["A"], m.A_np, rtol=0,
                               atol=1e-12 * np.abs(m.A_np).max())
    ref = StokesReference(host, UM)
    assert np.array_equal(ref.free.numpy(), m.free.numpy())
    np.testing.assert_allclose(ref.u_bc.numpy(), m.u_bc.numpy(), rtol=0,
                               atol=1e-15)
    x = torch.randn(m.n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    q = torch.randn(m.Q.ndof, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    for a, b in ((ref.A(x), m.A_raw(x)), (ref.B(x), m.B_raw(x)),
                 (torch.where(ref.free, ref.BT(q), 0.0), m.BT(q))):
        assert float((a - b).abs().max()) <= 1e-11 * float(b.abs().max())
    # the true residual as the port's own check writes it, on any state
    u = torch.where(m.free, x, m.u_bc)
    f_mod = torch.where(m.free, m.f - m.A_raw(m.u_bc), 0.0)
    g_mod = -m.B_raw(m.u_bc)
    du = u - m.u_bc
    r0, r1 = f_mod - m.A(du) - m.BT(q), g_mod - m.B(du)
    want = float(torch.sqrt(r0 @ r0 + r1 @ r1)
                 / torch.sqrt(f_mod @ f_mod + g_mod @ g_mod))
    assert abs(ref.true_rel(u, q) - want) <= 1e-12 * want


def test_mcs_stokes_solve_op_is_ready():
    """The op the first further cell (``mcs3d.stokes``, PERF.md's Open
    questions) runs: whole flagship solves, each held to the reference."""
    import json
    from pathlib import Path

    from perfbench import harness

    root = Path(harness.__file__).parent
    spec = json.loads((root / "configs/mcs3d-cyl-h0.09.json").read_text())
    spec["maxh"] = MAXH
    traffic = json.loads((root / "traffic/stokes.json").read_text())
    mod = harness.load_module(root / "configs/mcs3d-cyl-h0.09.py", "t_mcs")
    system = mod.System(spec, 7, traffic, "cpu", harness.Parts(lambda: None))
    unit = system.run_unit()
    assert unit["its"] > 0 and not unit["failed"]
    material = system.release(np.random.default_rng(0))
    (name, value, limit), = mod.check(spec, material, "cpu")
    assert name == "stokes_rel" and value <= limit == 1e-8
    assert mod.table_bytes(spec, "stokes_solve", unit, {}) is None

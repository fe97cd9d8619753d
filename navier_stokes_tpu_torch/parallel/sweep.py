"""Reynolds-number ensembles: one viscosity per member, each advanced by
the fused IMEX step with the viscosity as an argument.

Counterpart of ``navier_stokes_tpu/parallel/sweep.py`` (BASELINE.json
config 5, "3D Navier-Stokes SIMPLE + vmapped Reynolds-number parameter
sweep"; the reference runs its parameter sweeps serially,
templates/run_navier_stokes_parameter_sweep.py:49-67).  The JAX package
vmaps the step over the ensemble axis; under ``vmap`` every member is still
an independent run whose inner CG loops stop at that member's own count (a
vmapped ``while_loop`` freezes converged members).  The port keeps those
semantics by advancing the members one at a time through the single-member
step, the ensemble's state held as one (B, n) tensor.  The viscosity stays
a 0-d device tensor inside the step (no host read of it); the ν-independent
element tables are built once per step function, and every square element
product of the step goes through the hand-written ``batched_local_matvec``
(float64 on the float64 models) or, for float32 face-block tables,
``block_mv``.

With ``device_mesh`` (a :class:`~.sharding.DeviceMesh`: every rank calls
the function with its own model) each rank advances its contiguous share
of the members and the final states are gathered in member order on every
rank, as the JAX functions shard the ensemble axis over a device mesh.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.assembly import (
    ScatterPlan,
    apply_local_matrices,
    diagonal_of_local,
)
from ..solvers.cg import cg
from .sharding import gather_rows, share

__all__ = ["make_viscosity_step", "mcs_nu_split_tables",
           "make_viscosity_step_mcs", "run_reynolds_ensemble_mcs",
           "run_reynolds_ensemble", "advance_ensemble", "ensemble_rank"]


def make_viscosity_step(model):
    """A fused IMEX step ``step(u, nu) -> u_next`` of a Taylor-Hood
    ``NavierStokes`` model with the viscosity as an argument (a float or a
    0-d tensor).

    Built from the model's ν-independent tables (``K_loc``, ``M_loc``,
    ``DD_loc``); the inner M* solve takes a Jacobi preconditioner whose
    diagonal is recomputed from ν in every step.  Every element apply is
    :func:`~navier_stokes_tpu_torch.ops.assembly.apply_local_matrices`
    through the kernel: the stiffness and the mass per component, the
    grad-div term as one (nb d)^2 block per element."""
    d, n, dt = model.d, model.n, model.timestep
    dtype, dev = model.dtype, model.device
    free, f, gd = model.free_s, model.f, model.grad_div
    convection = model.convection
    project = model._project_velocity
    model._mass_chebyshev()  # the Lanczos bounds, before the first step
    eldofs = model.tu.eldofs
    ne, nb = model.M_loc.shape[:2]
    K_loc = model.K_loc.contiguous()
    M_loc = model.M_loc.contiguous()
    DD_tab = model.DD_loc.reshape(ne, nb * d, nb * d).contiguous()
    plan = ScatterPlan(eldofs, n)
    # flat dof of (e, j, b): b*n + eldofs[e, j], the component innermost
    comp = torch.arange(d, device=dev) * n
    plan_ia = ScatterPlan((eldofs[:, :, None] + comp).reshape(ne, nb * d),
                          d * n)

    diagK = diagonal_of_local(K_loc, plan, n)
    dd_diag = torch.einsum("eiaia->eia", model.DD_loc)
    diagDD = torch.stack([plan(dd_diag[:, :, c]) for c in range(d)])
    diagM = diagonal_of_local(M_loc, plan, n)

    def per_component(table, u2):
        return torch.stack([apply_local_matrices(table, plan, n, u2[c],
                                                 use_kernel=True)
                            for c in range(d)])

    def stokesA_raw(u2, nu):
        y = nu * per_component(K_loc, u2)
        if gd:
            y = y + gd * nu * apply_local_matrices(
                DD_tab, plan_ia, d * n, u2.reshape(-1),
                use_kernel=True).reshape(d, n)
        return y

    def step(u, nu):
        nu = torch.as_tensor(nu, dtype=dtype, device=dev)
        u2 = u.reshape(d, n)
        temp = convection(u).reshape(d, n) + f - stokesA_raw(u2, nu)
        temp = torch.where(free[None], temp, 0.0).reshape(-1)

        diag_mstar = diagM[None] + dt * nu * (diagK[None] + gd * diagDD)
        diag_mstar = torch.where(free[None], diag_mstar, 1.0)
        inv_diag = (1.0 / diag_mstar).reshape(-1)

        def mstar(v):
            v2 = v.reshape(d, n)
            vf = torch.where(free[None], v2, 0.0)
            y = per_component(M_loc, vf) + dt * stokesA_raw(vf, nu)
            return torch.where(free[None], y, v2).reshape(-1)

        res = cg(mstar, temp, pre=lambda v: inv_diag * v, tol=1e-4,
                 maxsteps=2000)
        model.last_iterations["mstar"] = res.iterations
        temp2, _ = project(res.x)
        return u + dt * temp2

    step.tables = {"K_loc": K_loc, "M_loc": M_loc, "DD": DD_tab}
    return step


def _sandwich(R, X, Q):
    """R X Q^T per element, by batched matrix products."""
    return R @ X @ Q.transpose(0, 2, 1)


def mcs_nu_split_tables(model):
    """Split the condensed MCS operator into ν-independent element tables:

        A_cond(ν) = ν G1 + G2 + (1/ν) G3.

    The 4-field element system has A_cc(ν) = T_ν Abar T_ν with T_ν =
    diag(1/sqrt(2ν) on sigma, sqrt(2ν) on W) and ν-independent A_rc, so
    the condensation's Schur term A_rc A_cc^{-1} A_rc^T splits into
    (sigma, sigma) ~ 2ν, cross terms ~ 1 and (W, W) ~ 1/(2ν); the retained
    block is the grad-div term ~ ν.  Three fixed tables serve every
    viscosity of a sweep.  Computed in float64 numpy on the host, as the
    JAX package does (its einsums as batched matrix products), in element
    order: numpy (ne, nb, nb) arrays."""
    nu0 = model.nu
    A_rc = np.asarray(model._A_rc, np.float64)
    Acc_inv = np.asarray(model._Acc_inv, np.float64)
    nbs = model.sigma_basis.n_basis
    # Abar^{-1} = T_nu0 @ Acc_inv(nu0) @ T_nu0
    a = 1.0 / np.sqrt(2.0 * nu0)
    scale = np.concatenate(
        [np.full(nbs, a), np.full(Acc_inv.shape[1] - nbs, 1.0 / a)])
    Abar_inv = Acc_inv * scale[None, :, None] * scale[None, None, :]
    R_s = A_rc[:, :, :nbs]  # sigma columns
    R_w = A_rc[:, :, nbs:]  # W columns
    S_ss = _sandwich(R_s, Abar_inv[:, :nbs, :nbs], R_s)
    S_sw = _sandwich(R_s, Abar_inv[:, :nbs, nbs:], R_w)
    S_ww = _sandwich(R_w, Abar_inv[:, nbs:, nbs:], R_w)
    # A_ret (pure grad-div ~ nu) recovered from the stored condensed matrix
    A_ret = np.asarray(model.A_cond_np, np.float64) + _sandwich(
        A_rc, Acc_inv, A_rc)
    G1 = A_ret / nu0 - 2.0 * S_ss
    G2 = -(S_sw + S_sw.transpose(0, 2, 1))
    G3 = -0.5 * S_ww
    return G1, G2, G3


def make_viscosity_step_mcs(model, mstar_tol: float = 1e-4):
    """A fused IMEX step ``step(u, nu) -> u_next`` of a ``NavierStokesMCS``
    model (3D or 2D) with the viscosity as an argument (a float or a 0-d
    tensor); ``mstar_tol``: the relative tolerance of its M* CG (the JAX
    step's 1e-4).  One gather/scatter round trip applies all three ν-split
    tables: in 3D the face-block layout's ``elem_apply_multi`` on the
    face-major tables, in 2D ``apply_local_matrices`` on the element dofs,
    each term through the kernel.  The model's lazy setup (Chebyshev
    bounds, projection preconditioner, convection and mass tables) is built
    here, before the first step.  ``step.tables``: the device tables G1,
    G2, G3 and the mass M."""
    G1, G2, G3 = mcs_nu_split_tables(model)
    dt, free, f, n = model.timestep, model.free, model.f, model.n
    dtype, dev = model.dtype, model.device
    convection = model.convection
    project = model._project_velocity
    model._mass_chebyshev()
    model._pre_proj_twolevel()
    model._build_convection()
    eldofs = model.Xv.element_dofs
    M_np = np.asarray(model._M_loc_np)

    def diag_of(loc):
        dg = np.zeros(n)
        np.add.at(dg, np.asarray(eldofs).ravel(),
                  np.einsum("eii->ei", loc).ravel())
        return torch.as_tensor(dg, device=dev).to(dtype)

    dG1, dG2, dG3, dM = (diag_of(x) for x in (G1, G2, G3, M_np))

    def ship(g):
        return torch.as_tensor(g, device=dev).to(dtype).contiguous()

    Mj = model._M_loc  # face-major in 3D
    if model.fb is not None:
        lay = model.fb
        G1j, G2j, G3j = (ship(lay.permute_blocks(g)) for g in (G1, G2, G3))

        def apply_tabs(coeffs_and_mats):
            return lay.elem_apply_multi(coeffs_and_mats)
    else:
        G1j, G2j, G3j = (ship(g) for g in (G1, G2, G3))
        plan = ScatterPlan(torch.as_tensor(
            np.asarray(eldofs, np.int64), device=dev), n)

        def apply_tabs(coeffs_and_mats):
            def apply(u):
                y = 0.0
                for mat, c in coeffs_and_mats:
                    t = apply_local_matrices(mat, plan, n, u,
                                             use_kernel=True)
                    y = y + (t if c is None else c * t)
                return y

            return apply

    mass = apply_tabs([(Mj, None)])

    def step(u, nu):
        nu = torch.as_tensor(nu, dtype=dtype, device=dev)
        A_raw = apply_tabs([(G1j, nu), (G2j, None), (G3j, 1.0 / nu)])
        temp = convection(u) + f - A_raw(u)
        temp = torch.where(free, temp, 0.0)

        diag_mstar = dM + dt * (nu * dG1 + dG2 + dG3 / nu)
        diag_mstar = torch.where(free & (diag_mstar.abs() > 1e-30),
                                 diag_mstar.abs(), 1.0)

        def mstar(v):
            vf = torch.where(free, v, 0.0)
            y = mass(vf) + dt * A_raw(vf)
            return torch.where(free, y, v)

        res = cg(mstar, temp,
                 pre=lambda v: torch.where(free, v / diag_mstar, v),
                 tol=mstar_tol, maxsteps=2000)
        model.last_iterations["mstar"] = res.iterations
        temp2, _ = project(res.x)
        return u + dt * temp2

    step.tables = {"G1": G1j, "G2": G2j, "G3": G3j, "M": Mj}
    return step


def advance_ensemble(model, step, nus, n_steps: int, log=None,
                     device_mesh=None):
    """(len(nus), n) final states: member i advanced ``n_steps`` times by
    ``step(u, nus[i])`` from the model's state, one member after the other.
    ``log``: a list that receives one dict per member step (member, step,
    the model's M* and projection CG counts, host seconds).
    ``device_mesh``: advance only this rank's share of the members, then
    gather every rank's states in member order."""
    nus = torch.as_tensor(nus, dtype=model.dtype, device=model.device)
    batch = model.u.reshape(1, -1).repeat(len(nus), 1)
    lo, hi = (0, len(nus)) if device_mesh is None else share(len(nus),
                                                             device_mesh)
    for i in range(lo, hi):
        u = batch[i]
        for k in range(n_steps):
            t0 = time.perf_counter()
            u = step(u, nus[i])
            if log is not None:
                if u.is_cuda:
                    torch.cuda.synchronize(u.device)
                log.append(dict(member=i, step=k,
                                seconds=time.perf_counter() - t0,
                                **model.last_iterations))
        batch[i] = u
    if device_mesh is None:
        return batch
    return gather_rows(device_mesh, batch[lo:hi], len(nus))


def run_reynolds_ensemble_mcs(model, nus, n_steps: int, log=None,
                              mstar_tol: float = 1e-4, device_mesh=None,
                              axis: str = "shard"):
    """Advance a viscosity ensemble of a ``NavierStokesMCS`` model: one
    member per viscosity, ``n_steps`` fused steps each.  Returns the
    (len(nus), model.n) final states on the model's device (``log``,
    ``device_mesh``: see :func:`advance_ensemble`; ``mstar_tol``: see
    :func:`make_viscosity_step_mcs`).  ``axis``: the mesh axis (one: the
    world)."""
    del axis
    step = make_viscosity_step_mcs(model, mstar_tol)
    return advance_ensemble(model, step, nus, n_steps, log, device_mesh)


def run_reynolds_ensemble(model, nus, n_steps: int, log=None,
                          device_mesh=None, axis: str = "shard"):
    """Advance one member per viscosity of a Taylor-Hood ``NavierStokes``
    model for ``n_steps`` fused steps.  Returns the (len(nus), d * n) final
    velocities on the model's device (``log``, ``device_mesh``: see
    :func:`advance_ensemble`; ``axis``: the mesh axis)."""
    del axis
    step = make_viscosity_step(model)
    return advance_ensemble(model, step, nus, n_steps, log, device_mesh)


def ensemble_rank(mesh, build, build_kwargs: dict, nus, n_steps: int,
                  taylor_hood: bool = False):
    """Rank body: build the model ``build(**build_kwargs, device=...)`` on
    this rank's device (``build`` and its arguments picklable: a model
    class or ``flagship.build_model``, a mesh, a module-level inflow) and
    run its Reynolds ensemble with ``device_mesh=mesh``.  Returns the
    (len(nus), n) final states, on every rank."""
    model = build(**build_kwargs, device=mesh.device)
    run = run_reynolds_ensemble if taylor_hood else run_reynolds_ensemble_mcs
    return run(model, nus, n_steps, device_mesh=mesh)

"""Upwind DG convection for 2D H(div) velocities (matrix-free).

Counterpart of ``navier_stokes_tpu/ops/convection.py`` (the reference's
convection operator, templates/NavierStokesSIMPLE_iterative.py:106-113:
int (u ox u) : grad v plus the upwind facet flux
``-IfPos(u.n, u.n u.v, u.n u_other.v)``, boundary "other" values taken from
the inflow profile).  H(div) velocities have a continuous normal flux u.n,
so the upwind switch is well defined facet-wise.

The host tables are built in numpy exactly as there (the facet traces
aligned to ascending global edge parameter); the apply is torch, designed
as ``ops/convection3d.py``: the value, gradient and trace tables are stored
with the basis index innermost ((e, q*c, i) and (e, i, q*c*d)) so that each
contraction is one ``torch.bmm`` over a contiguous table, the five-operand
volume einsum is contracted in two steps (the weighted u (x) u at the
quadrature points, then one product with the gradient table), and the
volume and both facet contributions are summed onto the dofs by ONE
deterministic scatter (ops/assembly.ScatterPlan): no float atomics.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..fem.hdiv import HDivSpace
from ..fem.quadrature import triangle_rule
from .assembly import ScatterPlan
from .facets import facet_geometry

__all__ = ["build_upwind_convection"]


def build_upwind_convection(V: HDivSpace, uin=None, nq1: int | None = None,
                            dtype=torch.float64, device=None):
    """conv(u)[i] = int (u ox u):grad(v_i) - sum_T int_dT u.n (u_up . v_i) ds
    -- the weak form of -(u.grad)u for solenoidal u, the sign the IMEX update
    u += dt*(conv + f - A u) expects.  ``uin``: boundary data at physical
    points (None: zero)."""
    device = resolve_device(device)
    mesh = V.mesh
    hb = V.basis
    k = hb.order
    if nq1 is None:
        nq1 = 2 * k + 2
    J, detJ, Jinv = mesh.element_jacobians
    ne = mesh.ne
    nb = hb.n_basis

    def ship(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

    # -- volume term tables (Piola values and gradients, signs folded) -------
    vol = triangle_rule(3 * k)
    nq = len(vol.weights)
    v_val, v_grad = hb.tabulate(vol.points)
    signs = V.element_signs
    val_p = np.einsum("ecA,qiA->eqic", J, v_val) / detJ[:, None, None, None]
    val_p = val_p * signs[:, None, :, None]
    # (e, q, i, c) -> (e, q*c, i)
    val_t = ship(val_p.transpose(0, 1, 3, 2).reshape(ne, nq * 2, nb))
    del val_p
    grad_p = np.einsum(
        "ecA,qiAB,eBd->eqicd", J, v_grad, Jinv
    ) / detJ[:, None, None, None, None]
    grad_p = grad_p * signs[:, None, :, None, None]
    # (e, q, i, c, d) -> (e, i, q*c*d)
    grad_t = ship(grad_p.transpose(0, 2, 1, 3, 4).reshape(ne, nb, nq * 4))
    del grad_p

    # -- facet tables (global-t aligned, per facet side) ---------------------
    fg = facet_geometry(mesh, nq1)
    t = fg.t
    tv = [hb.tabulate(fg.ref_points[le])[0] for le in range(3)]  # (nq,nb,2)

    nfacet = mesh.nfacet
    fe_pairs = [[] for _ in range(nfacet)]  # (elem, local_edge) per side
    for le in range(3):
        for e, f in enumerate(mesh.element_edges[:, le]):
            fe_pairs[f].append((e, le))

    trace = np.zeros((2, nfacet, nq1, nb, 2))
    side_elem = np.zeros((2, nfacet), dtype=np.int64)
    has_right = np.zeros(nfacet, dtype=bool)
    n_g = np.zeros((nfacet, 2))
    elen = np.zeros(nfacet)
    for f, pairs in enumerate(fe_pairs):
        for s, (e, le) in enumerate(pairs):
            vals = np.einsum("cA,qiA->qic", J[e], tv[le]) / detJ[e]
            vals = vals * signs[e][None, :, None]
            if fg.flip[e, le]:
                vals = vals[::-1]  # align ascending global t (GL symmetric)
            trace[s, f] = vals
            side_elem[s, f] = e
        if len(pairs) == 2:
            has_right[f] = True
        else:
            side_elem[1, f] = side_elem[0, f]
        # left outward normal / edge length
        e0, le0 = pairs[0]
        n_g[f] = fg.normal[e0, le0]
        elen[f] = fg.elen[e0, le0]

    # boundary "other" values: uin at the facet quadrature points (the
    # u.Other(bnd=uin) semantics; only matters where u.n < 0)
    ev = mesh.points[mesh.edges]
    pa, pb = ev[:, 0], ev[:, 1]
    pts_f = pa[:, None, :] + t[None, :, None] * (pb - pa)[:, None, :]
    if uin is not None:
        ub = uin(pts_f.reshape(-1, 2)).reshape(nfacet, nq1, 2)
    else:
        ub = np.zeros((nfacet, nq1, 2))
    ub = np.where(has_right[:, None, None], 0.0, ub)

    eldofs = torch.as_tensor(V.element_dofs.astype(np.int64), device=device)
    dofs_L = torch.as_tensor(V.element_dofs[side_elem[0]].astype(np.int64),
                             device=device)
    dofs_R = torch.as_tensor(V.element_dofs[side_elem[1]].astype(np.int64),
                             device=device)
    # (f, q, i, c) -> (f, q*c, i)
    trace_L = ship(trace[0].transpose(0, 1, 3, 2).reshape(nfacet, nq1 * 2, nb))
    trace_R = ship(trace[1].transpose(0, 1, 3, 2).reshape(nfacet, nq1 * 2, nb))
    del trace
    n_g_t = ship(n_g)
    ub_t = ship(ub)
    has_right_t = torch.as_tensor(has_right, device=device)
    # quadrature weight x geometry factors, folded once
    w_face = ship(fg.w[None, :] * elen[:, None])  # (f, q)
    w_vol = ship(vol.weights[None, :] * detJ[:, None])  # (e, q)
    ndof = V.ndof
    # one scatter for the three sets of contributions, in this order
    scatter = ScatterPlan(torch.cat([eldofs.reshape(-1), dofs_L.reshape(-1),
                                     dofs_R.reshape(-1)]), ndof)

    def conv(u):
        ue = u[eldofs]
        uq = torch.bmm(val_t, ue[:, :, None]).reshape(ne, nq, 2)
        uu = (w_vol[:, :, None, None] * uq[:, :, :, None]
              * uq[:, :, None, :]).reshape(ne, nq * 4, 1)
        fe_vol = torch.bmm(grad_t, uu).reshape(ne, nb)

        uL = torch.bmm(trace_L, u[dofs_L][:, :, None]).reshape(nfacet, nq1, 2)
        uR_in = torch.bmm(trace_R, u[dofs_R][:, :, None]).reshape(
            nfacet, nq1, 2)
        uR = torch.where(has_right_t[:, None, None], uR_in, ub_t)
        un = torch.einsum("fqc,fc->fq", uL, n_g_t)
        u_up = torch.where(un[..., None] > 0, uL, uR)
        flux = ((w_face * un)[..., None] * u_up).reshape(nfacet, 1, nq1 * 2)
        fe_L = -torch.bmm(flux, trace_L).reshape(nfacet, nb)
        fe_R = torch.bmm(flux, trace_R).reshape(nfacet, nb)
        fe_R = torch.where(has_right_t[:, None], fe_R, 0.0)
        return scatter(torch.cat([fe_vol.reshape(-1), fe_L.reshape(-1),
                                  fe_R.reshape(-1)]))

    conv.tables = {"val": val_t, "grad": grad_t, "trace_L": trace_L,
                   "trace_R": trace_R}
    return conv

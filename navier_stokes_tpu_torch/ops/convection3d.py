"""Upwind DG convection for 3D H(div) velocities (matrix-free).

Counterpart of ``navier_stokes_tpu/ops/convection3d.py``.  Because the facet
quadrature points live in each face's GLOBAL sorted-vertex frame
(ops/facets3d), the two neighboring tets evaluate their traces at literally
the same physical points -- the upwind switch needs no index alignment.

The host tables are built in numpy exactly as there; the apply is torch.
The value, gradient and trace tables are stored with the basis index
innermost ((e, q*c, i) and (e, i, q*c*d)) so that every contraction is one
``torch.bmm`` over a contiguous table with no hidden copy: the JAX
package's five-operand volume einsum is contracted in two steps (the
weighted u (x) u at the quadrature points, then one batched product with the
gradient table), which never materializes an (e, q, i, c, d)-sized
temporary.  The volume and the two facet contributions are summed onto
the dofs by ONE deterministic scatter (ops/assembly.ScatterPlan over the
three index tables side by side): no float atomics, so that a step repeats
bitwise on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..fem.hdiv3d import HDivSpace3D
from ..fem.quadrature import tetrahedron_rule
from .assembly import ScatterPlan
from .facets3d import facet_geometry_3d

__all__ = ["build_upwind_convection_3d"]


def build_upwind_convection_3d(V: HDivSpace3D, uin=None,
                               dtype=torch.float64, device=None):
    """conv(u)[i] = int (u ox u):grad(v_i) - sum_T int_dT u.n (u_up . v_i) dS
    -- the weak form of -(u.grad)u for solenoidal u.  ``uin``: boundary
    data at the physical points of the boundary faces (None: zero)."""
    device = resolve_device(device)
    mesh = V.mesh
    k = V.order
    J, detJ, Jinv = mesh.element_jacobians
    ne = mesh.ne
    nb = V.n_basis

    def ship(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

    vol = tetrahedron_rule(3 * k)
    nq = len(vol.weights)
    v_val, v_grad = V.tabulate_elements(vol.points)
    # Piola value/gradient via batched 3x3 matmuls
    val_p = np.matmul(v_val, J.transpose(0, 2, 1)[:, None]) / detJ[:, None, None, None]
    del v_val
    # (e, q, i, c) -> (e, q*c, i)
    val_t = ship(val_p.transpose(0, 1, 3, 2).reshape(ne, nq * 3, nb))
    del val_p
    grad_p = np.matmul(
        J[:, None, None], np.matmul(v_grad, Jinv[:, None, None])
    ) / detJ[:, None, None, None, None]
    del v_grad
    # (e, q, i, c, d) -> (e, i, q*c*d)
    grad_t = ship(grad_p.transpose(0, 2, 1, 3, 4).reshape(ne, nb, nq * 9))
    del grad_p

    fg = facet_geometry_3d(mesh, 2 * k + 2)
    nq2 = len(fg.qp)

    nfacet = mesh.nfacet
    fe_pairs = [[] for _ in range(nfacet)]
    for lf in range(4):
        for e, f in enumerate(mesh.element_faces[:, lf]):
            fe_pairs[f].append((e, lf))

    trace = np.zeros((2, nfacet, nq2, nb, 3))
    side_elem = np.zeros((2, nfacet), dtype=np.int64)
    side_lf = np.zeros((2, nfacet), dtype=np.int64)
    has_right = np.zeros(nfacet, dtype=bool)
    n_g = np.zeros((nfacet, 3))
    area = np.zeros(nfacet)
    for f, pairs in enumerate(fe_pairs):
        for s, (e, lf) in enumerate(pairs):
            side_elem[s, f] = e
            side_lf[s, f] = lf
        e0, lf0 = pairs[0]
        n_g[f] = fg.normal[e0, lf0]
        area[f] = fg.area[e0, lf0]
        if len(pairs) == 2:
            has_right[f] = True
        else:
            side_elem[1, f] = side_elem[0, f]
            side_lf[1, f] = side_lf[0, f]

    # physical traces, grouped by (combo, local face): ~24 distinct
    # reference tabulations, each pushed through its group's Piola maps as
    # one batched matmul
    ref_tab: dict[tuple[int, int], np.ndarray] = {}
    for s in (0, 1):
        els, lfs = side_elem[s], side_lf[s]
        cids = V.combo_ids[els]
        for cid in range(len(V.bases)):
            for lf in range(4):
                sel = np.where((cids == cid) & (lfs == lf))[0]
                if not len(sel):
                    continue
                key = (cid, lf)
                if key not in ref_tab:
                    ref_tab[key] = V.bases[cid].tabulate(
                        fg.ref_points[els[sel[0]], lf]
                    )[0]  # (nq2, nb, 3)
                eg = els[sel]
                trace[s, sel] = np.matmul(
                    ref_tab[key][None], J[eg].transpose(0, 2, 1)[:, None]
                ) / detJ[eg, None, None, None]

    # boundary data at global-frame face quad points
    pv = mesh.points[mesh.faces]  # (nfacet, 3, 3) sorted vertices
    pts_f = (
        pv[:, 0][:, None, :]
        + fg.qp[None, :, 0:1] * (pv[:, 1] - pv[:, 0])[:, None, :]
        + fg.qp[None, :, 1:2] * (pv[:, 2] - pv[:, 0])[:, None, :]
    )
    if uin is not None:
        ub = uin(pts_f.reshape(-1, 3)).reshape(nfacet, nq2, 3)
    else:
        ub = np.zeros((nfacet, nq2, 3))
    ub = np.where(has_right[:, None, None], 0.0, ub)

    eldofs = torch.as_tensor(V.element_dofs[:, :nb].astype(np.int64),
                             device=device)
    dofs_L = torch.as_tensor(
        V.element_dofs[side_elem[0], :nb].astype(np.int64), device=device)
    dofs_R = torch.as_tensor(
        V.element_dofs[side_elem[1], :nb].astype(np.int64), device=device)
    # (f, q, i, c) -> (f, q*c, i)
    trace_L = ship(trace[0].transpose(0, 1, 3, 2).reshape(nfacet, nq2 * 3, nb))
    trace_R = ship(trace[1].transpose(0, 1, 3, 2).reshape(nfacet, nq2 * 3, nb))
    del trace
    n_g_t = ship(n_g)
    ub_t = ship(ub)
    has_right_t = torch.as_tensor(has_right, device=device)
    # quadrature weight x geometry factors, folded once
    w_face = ship(fg.qw[None, :] * area[:, None])  # (f, q)
    w_vol = ship(vol.weights[None, :] * detJ[:, None])  # (e, q)
    ndof = V.ndof
    # one scatter for the three sets of contributions, in this order
    scatter = ScatterPlan(torch.cat([eldofs.reshape(-1), dofs_L.reshape(-1),
                                     dofs_R.reshape(-1)]), ndof)

    def conv(u):
        ue = u[eldofs]
        uq = torch.bmm(val_t, ue[:, :, None]).reshape(ne, nq, 3)
        # w_q detJ_e u_c u_d at the quadrature points, then one product
        # with the (e, i, q*c*d) gradient table
        uu = (w_vol[:, :, None, None] * uq[:, :, :, None]
              * uq[:, :, None, :]).reshape(ne, nq * 9, 1)
        fe_vol = torch.bmm(grad_t, uu).reshape(ne, nb)

        uL = torch.bmm(trace_L, u[dofs_L][:, :, None]).reshape(nfacet, nq2, 3)
        uR_in = torch.bmm(trace_R, u[dofs_R][:, :, None]).reshape(
            nfacet, nq2, 3)
        uR = torch.where(has_right_t[:, None, None], uR_in, ub_t)
        un = torch.einsum("fqc,fc->fq", uL, n_g_t)
        u_up = torch.where(un[..., None] > 0, uL, uR)
        flux = ((w_face * un)[..., None] * u_up).reshape(nfacet, 1, nq2 * 3)
        fe_L = -torch.bmm(flux, trace_L).reshape(nfacet, nb)
        fe_R = torch.bmm(flux, trace_R).reshape(nfacet, nb)
        fe_R = torch.where(has_right_t[:, None], fe_R, 0.0)
        return scatter(torch.cat([fe_vol.reshape(-1), fe_L.reshape(-1),
                                  fe_R.reshape(-1)]))

    conv.tables = {"val": val_t, "grad": grad_t, "trace_L": trace_L,
                   "trace_R": trace_R}
    return conv

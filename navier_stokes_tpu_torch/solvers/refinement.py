"""Jacobi-equilibrated split-f32 and compensated operators of the flagship
3D MCS solve.

Counterpart of the face-block branch of ``equilibrated_f32_ops`` in
``navier_stokes_tpu/solvers/refinement.py``, host-table derivation (the JAX
package's ``NSTPU_DEVICE_TABLES=0`` path, which is what it computes on the
CPU): the condensed matrix on the sliver-heavy channel mesh spans a dynamic
range far beyond float32, so the f32 inner system is the symmetrically
equilibrated A~ = D A D with D = diag(A)^{-1/2} on the free dofs.  The
equilibration and the hi/lo split run in f64 on the host; the f32 tables go
to the device once and serve both solve phases:

* phase 1 (``ops32``): A32 = (A_hi + A_lo) u through one :func:`block_mv2`
  stream, B32/BT32 likewise, the skeleton preconditioner preA32
  (models/auxspace3d.py) and the pressure-mass preconditioner preM32;
* phase 2 and the per-pass residuals (``ops_ds``): the same hi/lo tables
  through the compensated double-single kernel :func:`block_mv_comp`, f64
  in and out, ~2^-45 of the uncancelled row sum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.auxspace3d import build_skeleton_preconditioner_3d

__all__ = ["equilibrated_f32_ops", "split_table"]


def split_table(A64: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f64 table -> f32 (hi, lo) with hi + lo == A64 to ~2^-48 relative."""
    hi = A64.astype(np.float32)
    lo = (A64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def equilibrated_f32_ops(m, gs: bool = True, split_k: int = 1):
    """Jacobi-equilibrated operator bundles for a 3D MCS model ``m``
    (:class:`~navier_stokes_tpu_torch.models.NavierStokesMCS`).

    Returns ``(ops32, D, ops_ds)``:

    * ``ops32`` = dict(A, B, BT, preA, preM) acting in float32 on the SCALED
      velocity u~ = D^{-1} u (pressure unscaled);
    * ``D``: the (n,) float64 scaling on ``m.device``;
    * ``ops_ds`` = dict(A, B, BT): the same equilibrated system in float64
      through the compensated kernel.

    Residual mapping for refinement: r~0 = D r0, r~1 = r1; solution mapping
    dx0 = D dx~0.  This is ``equilibrated_f32_ops(gs, split=True,
    with_ds=True)`` of the JAX package with bench.py's settings: ``gs``
    (``BENCH_GS``) picks the symmetric multicolor GS skeleton
    preconditioner over the additive one; ``split_k`` is ``NSTPU_SPLITK``
    (1): above 1 the A32 pair, the compensated A, B, BT and the
    preconditioner's split tables stream through the split-k kernels.  The
    preconditioner's table storage groups (``NSTPU_SMOOTHER_BF16=ext,inv``)
    and coarse damping target (``NSTPU_COARSE_TARGET=1.6``) are bench.py's,
    the defaults of :func:`~navier_stokes_tpu_torch.models.auxspace3d.
    build_skeleton_preconditioner_3d`.  Arithmetic is f32."""
    dev = m.device
    lay = m.fb
    A_loc = m.A_cond_np
    eldofs = np.asarray(m.Xv.element_dofs)
    d = np.zeros(m.n)
    np.add.at(d, eldofs.ravel(), np.einsum("eii->ei", A_loc).ravel())
    free_np = np.asarray(m.Xv.free_mask)
    D = np.ones(m.n)
    D[free_np] = 1.0 / np.sqrt(np.maximum(np.abs(d[free_np]), 1e-300))
    De = D[eldofs]
    A_s = A_loc * De[:, :, None] * De[:, None, :]
    free = m.free

    # one device copy of the hi/lo tables serves phase 1 and phase 2
    A_hi_np, A_lo_np = split_table(lay.permute_blocks(A_s))
    shared = lay.pack_elem_tables([A_hi_np, A_lo_np], split_k)
    del A_hi_np, A_lo_np
    _A32 = lay.elem_apply_tiled(shared)
    _A_ds = lay.elem_apply_comp(*shared)

    B_sp = (m.B_loc_np * De[:, None, :])[:, :, lay.perm]
    B_shared = lay.pack_elem_tables(split_table(B_sp))
    _B32, _BT32 = lay.rect_apply_multi(B_shared, m.Q.element_dofs)
    _B_ds, _BT_ds = lay.rect_apply_comp(*B_shared, m.Q.element_dofs,
                                        split_k=split_k)

    def A32(u):
        uf = torch.where(free, u, 0.0)
        return torch.where(free, _A32(uf), u)

    def B32(u):
        return _B32(torch.where(free, u, 0.0))

    def BT32(p):
        return torch.where(free, _BT32(p), 0.0)

    def A_ds(u):
        uf = torch.where(free, u, 0.0)
        return torch.where(free, _A_ds(uf), u)

    def B_ds(u):
        return _B_ds(torch.where(free, u, 0.0))

    def BT_ds(p):
        return torch.where(free, _BT_ds(p), 0.0)

    # the device tables each apply streams, for kernel checks and timings
    for op, inner in ((A32, _A32), (B32, _B32), (BT32, _BT32), (A_ds, _A_ds),
                      (B_ds, _B_ds), (BT_ds, _BT_ds)):
        op.tables = inner.tables

    preA32 = build_skeleton_preconditioner_3d(
        m.Xv, A_s, m._dirich, dev, torch.float32,
        coarse_coefficient=m.nu, dof_scale=D, gs=gs, split_k=split_k,
    )
    diag_Mp32 = torch.as_tensor(m._diag_Mp, device=dev).to(torch.float32)
    nu32 = float(np.float32(m.nu))

    def preM32(p):
        return nu32 * p / diag_Mp32

    ops32 = dict(A=A32, B=B32, BT=BT32, preA=preA32, preM=preM32)
    ops_ds = dict(A=A_ds, B=B_ds, BT=BT_ds)
    return ops32, torch.as_tensor(D, device=dev), ops_ds

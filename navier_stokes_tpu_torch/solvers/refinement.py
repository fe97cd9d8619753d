"""Mixed-precision iterative refinement for saddle-point solves, and the
Jacobi-equilibrated split-f32 and compensated operators of the flagship 3D
MCS solve.

The refinement drivers are the JAX package's
(``navier_stokes_tpu/solvers/refinement.py``): outer residuals and
accumulation in f64, inner Bramble-Pasciak CG
(:func:`mixed_precision_saddle_solve`, ``_scaled``) or MINRES
(:func:`mixed_precision_minres_refinement`, ``_2phase``) solves in f32,
each pass kept only when it lowers the true f64 residual (the monotonicity
guard: a failed or diverged inner pass must not poison the iterate), and
:func:`solve_initial_refined` for an f64 / f32 model pair.  The JAX
package runs each refinement loop as one ``lax.while_loop``; here it is a
Python loop with one host read per pass (the new residual), beside the
inner solvers' own.

``abs_test`` of the MINRES drivers: the inner MINRES's absolute stopping
test.  :func:`mixed_precision_minres_refinement` keeps the JAX default
(True); deep-tolerance drivers pass :data:`DEEP_ABS_TEST` (False), the one
place the value is named: the 2-phase driver and the face-sharded solve
(``parallel/faceshard.py``) pass it.

``group`` of the MINRES drivers: on vectors split over the ranks of a
process group (each rank's block, ``parallel/sharding.py``), every inner
product -- the inner MINRES's and the outer residual norms -- is summed
over it; ``None`` keeps today's local dots.

The operators:
Counterpart of the face-block branch of ``equilibrated_f32_ops`` in
``navier_stokes_tpu/solvers/refinement.py``, host-table derivation (the JAX
package's ``NSTPU_DEVICE_TABLES=0`` path, which is what it computes on the
CPU): the condensed matrix on the sliver-heavy channel mesh spans a dynamic
range far beyond float32, so the f32 inner system is the symmetrically
equilibrated A~ = D A D with D = diag(A)^{-1/2} on the free dofs.  The
equilibration and the hi/lo split run in f64 on the host; the f32 tables go
to the device once and serve both solve phases:

* phase 1 (``ops32``): A32 = (A_hi + A_lo) u through one :func:`block_mv2`
  stream, B32/BT32 likewise (``split=False``: the hi tables alone
  through :func:`block_mv`), the skeleton preconditioner preA32
  (models/auxspace3d.py) and the pressure-mass preconditioner preM32;
* phase 2 and the per-pass residuals (``ops_ds``): the same hi/lo tables
  through the compensated double-single kernel :func:`block_mv_comp`, f64
  in and out, ~2^-45 of the uncancelled row sum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.auxspace3d import build_skeleton_preconditioner_3d
from .bpcg import bp_scale_factor, bramble_pasciak_cg_opt
from .minres import minres

__all__ = ["DEEP_ABS_TEST", "equilibrated_f32_ops", "split_table",
           "mixed_precision_saddle_solve",
           "mixed_precision_saddle_solve_scaled",
           "mixed_precision_minres_refinement",
           "mixed_precision_minres_refinement_2phase",
           "solve_initial_refined"]

# the inner MINRES's absolute stopping test for refinement to a deep
# tolerance: on the shrinking per-pass right-hand side the absolute test
# fires early and floors the driver near 4e-7, so deep-tolerance callers
# drop it (the JAX package's 2-phase driver and bench.py do; its sharded
# solve passes it too, faceshard.py:1022, as the port's does)
DEEP_ABS_TEST = False

F32, F64 = torch.float32, torch.float64


def split_table(A64: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f64 table -> f32 (hi, lo) with hi + lo == A64 to ~2^-48 relative."""
    hi = A64.astype(np.float32)
    lo = (A64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def equilibrated_f32_ops(m, gs: bool = True, split: bool = True,
                         with_ds: bool = True, split_k: int = 1):
    """Jacobi-equilibrated operator bundles for a 3D MCS model ``m``
    (:class:`~navier_stokes_tpu_torch.models.NavierStokesMCS`).

    Returns ``(ops32, D, ops_ds)``, or ``(ops32, D)`` when ``with_ds`` is
    False:

    * ``ops32`` = dict(A, B, BT, preA, preM) acting in float32 on the SCALED
      velocity u~ = D^{-1} u (pressure unscaled);
    * ``D``: the (n,) float64 scaling on ``m.device``;
    * ``ops_ds`` = dict(A, B, BT): the same equilibrated system in float64
      through the compensated kernel, from the hi/lo pair whatever
      ``split``.

    Residual mapping for refinement: r~0 = D r0, r~1 = r1; solution mapping
    dx0 = D dx~0.  This is the JAX package's ``equilibrated_f32_ops(m, gs,
    split, with_ds)`` with bench.py's settings as defaults (the JAX
    function defaults to ``gs=False, split=False, with_ds=False``):
    ``split`` streams A32, B32 and BT32 as the hi/lo pair (one
    :func:`block_mv2` stream each); ``split=False`` streams the hi table
    alone (:func:`block_mv`).  ``gs`` (``BENCH_GS``) picks the symmetric
    multicolor GS skeleton preconditioner over the additive one;
    ``split_k`` is ``NSTPU_SPLITK`` (1): above 1 the A32 pair, the
    compensated A, B, BT and the preconditioner's split tables stream
    through the split-k kernels (with ``split`` only).  The
    preconditioner's table storage groups (``NSTPU_SMOOTHER_BF16=ext,inv``)
    and coarse damping target (``NSTPU_COARSE_TARGET=1.6``) are bench.py's,
    the defaults of :func:`~navier_stokes_tpu_torch.models.auxspace3d.
    build_skeleton_preconditioner_3d`.  Arithmetic is f32.  Only the JAX
    function's face-block branch is ported: every 3D model of both
    packages has a face-block layout ``m.fb``, and the skeleton
    preconditioner is 3D only."""
    if split_k > 1 and not split:
        raise ValueError("split-k tables are streamed as the hi/lo pair: "
                         "split_k > 1 needs split=True")
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
    n32 = 2 if split else 1  # tables of the f32 applies: hi (and lo)
    npack = 2 if split or with_ds else 1  # the lo tables when any op uses them

    # one device copy of the hi/lo tables serves phase 1 and phase 2
    A_hi_lo = split_table(lay.permute_blocks(A_s))
    shared = lay.pack_elem_tables(A_hi_lo[:npack], split_k)
    del A_hi_lo
    _A32 = lay.elem_apply_tiled(shared[:n32])

    B_sp = (m.B_loc_np * De[:, None, :])[:, :, lay.perm]
    B_shared = lay.pack_elem_tables(split_table(B_sp)[:npack])
    _B32, _BT32 = lay.rect_apply_multi(B_shared[:n32], m.Q.element_dofs)

    def A32(u):
        uf = torch.where(free, u, 0.0)
        return torch.where(free, _A32(uf), u)

    def B32(u):
        return _B32(torch.where(free, u, 0.0))

    def BT32(p):
        return torch.where(free, _BT32(p), 0.0)

    # the device tables each apply streams, for kernel checks and timings
    ops = [(A32, _A32), (B32, _B32), (BT32, _BT32)]
    ops_ds = None
    if with_ds:
        _A_ds = lay.elem_apply_comp(*shared)
        _B_ds, _BT_ds = lay.rect_apply_comp(*B_shared, m.Q.element_dofs,
                                            split_k=split_k)

        def A_ds(u):
            uf = torch.where(free, u, 0.0)
            return torch.where(free, _A_ds(uf), u)

        def B_ds(u):
            return _B_ds(torch.where(free, u, 0.0))

        def BT_ds(p):
            return torch.where(free, _BT_ds(p), 0.0)

        ops += [(A_ds, _A_ds), (B_ds, _B_ds), (BT_ds, _BT_ds)]
        ops_ds = dict(A=A_ds, B=B_ds, BT=BT_ds)
    for op, inner in ops:
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
    D_t = torch.as_tensor(D, device=dev)
    if with_ds:
        return ops32, D_t, ops_ds
    return ops32, D_t


# -- refinement drivers ------------------------------------------------------


def _f32_scale(scale_k) -> float:
    """The Bramble-Pasciak scaling as the f32 value the JAX drivers use."""
    return float(np.float32(scale_k))


class _Outer:
    """The f64 outer residual of [[A, B^T], [B, 0]] (x0, x1) = (f, g) and
    its norm relative to the right-hand side's."""

    def __init__(self, ops64, f, g, group=None):
        self.A, self.B, self.BT = ops64["A"], ops64["B"], ops64["BT"]
        self.f, self.g = f, g
        self.group = group
        self.rhs_norm = torch.sqrt(self._sq(f, g))

    def _sq(self, a, b):
        s = torch.dot(a, a) + torch.dot(b, b)
        return s if self.group is None else self.group.all_reduce(s)

    def residual(self, x):
        return (self.f - self.A(x[0]) - self.BT(x[1]),
                self.g - self.B(x[0]))

    def rel(self, r):
        return float(torch.sqrt(self._sq(*r)) / self.rhs_norm)


def _refine(outer, tol, max_passes, inner_solve, factor=1.0, start=None):
    """Refinement passes from ``start`` = (x, its residual), x = 0 when
    None: each pass solves for a correction of the residual
    (``inner_solve(r0, r1) -> (dx, iterations)``) and keeps it only when
    the new relative residual is below ``factor`` times the old one; a
    rejected pass ends the loop.  Returns (x, residual, relative residual,
    passes, inner iterations)."""
    if start is None:
        x = (torch.zeros_like(outer.f), torch.zeros_like(outer.g))
        start = (x, outer.residual(x))
    x, rv = start
    r = outer.rel(rv)
    passes = inner = 0
    while r > tol and passes < max_passes:
        dx, its = inner_solve(*rv)
        x_new = (x[0] + dx[0], x[1] + dx[1])
        rv_new = outer.residual(x_new)
        r_new = outer.rel(rv_new)  # the pass's one host read
        passes += 1
        inner += its
        if not r_new < factor * r:  # NaN fails too
            break
        x, rv, r = x_new, rv_new, r_new
    return x, rv, r, passes, inner


def mixed_precision_saddle_solve(ops64: dict, ops32: dict, f, g,
                                 tol: float = 1e-8, inner_tol: float = 1e-6,
                                 inner_maxsteps: int = 2000,
                                 max_refine: int = 6, scale_k=None):
    """Solve [[A, B^T], [B, 0]] (x0, x1) = (f, g) to f64 relative residual
    ``tol`` with f32 BPCG (v2) inner solves.

    ``ops64`` / ``ops32``: dicts with callables A, B, BT (and preA, preM in
    ``ops32``) acting in the respective dtype.  ``scale_k``: the
    Bramble-Pasciak scaling of the inner solver; estimated once (in f32,
    from the port's Lanczos start vector) when None.

    Returns (x, rel_residual, refinement_steps, total_inner_iterations)."""
    if scale_k is None:
        scale_k, _ = bp_scale_factor(ops32["A"], ops32["preA"], f.to(F32))
    k = _f32_scale(scale_k)
    outer = _Outer(ops64, f, g)

    def inner(r0, r1):
        res = bramble_pasciak_cg_opt(
            ops32["A"], ops32["B"], ops32["BT"], ops32["preA"],
            ops32["preM"], r0.to(F32), r1.to(F32), tol=inner_tol,
            maxsteps=inner_maxsteps, scale_k=k)
        return (res.x[0].to(F64), res.x[1].to(F64)), res.iterations

    x, _, r, steps, its = _refine(outer, tol, max_refine, inner)
    return x, r, steps, its


def mixed_precision_saddle_solve_scaled(ops64: dict, ops32: dict, D, f, g,
                                        tol: float = 1e-8,
                                        inner_tol: float = 1e-4,
                                        inner_maxsteps: int = 4000,
                                        max_refine: int = 8, scale_k=None):
    """:func:`mixed_precision_saddle_solve` for a Jacobi-equilibrated f32
    inner system (:func:`equilibrated_f32_ops`): inner rhs (D r0, r1),
    inner solution mapped back by D."""
    if scale_k is None:
        scale_k, _ = bp_scale_factor(ops32["A"], ops32["preA"],
                                     (D * f).to(F32))
    k = _f32_scale(scale_k)
    outer = _Outer(ops64, f, g)

    def inner(r0, r1):
        res = bramble_pasciak_cg_opt(
            ops32["A"], ops32["B"], ops32["BT"], ops32["preA"],
            ops32["preM"], (D * r0).to(F32), r1.to(F32), tol=inner_tol,
            maxsteps=inner_maxsteps, scale_k=k)
        return (D * res.x[0].to(F64), res.x[1].to(F64)), res.iterations

    x, _, r, steps, its = _refine(outer, tol, max_refine, inner)
    return x, r, steps, its


def _minres_f32(ops32, D, inner_tol, inner_maxsteps, abs_test, group=None):
    """The f32 MINRES correction solve on the equilibrated block system
    [[A, B^T], [B, 0]] with the block-diagonal preconditioner
    [[preA, 0], [0, preM]]."""

    def K32(x):
        u, p = x
        return (ops32["A"](u) + ops32["BT"](p), ops32["B"](u))

    def pre32(x):
        return (ops32["preA"](x[0]), ops32["preM"](x[1]))

    def inner(r0, r1):
        res = minres(K32, ((D * r0).to(F32), r1.to(F32)), pre=pre32,
                     tol=inner_tol, maxsteps=inner_maxsteps,
                     abs_test=abs_test, group=group)
        return (D * res.x[0].to(F64), res.x[1].to(F64)), res.iterations

    return inner


def mixed_precision_minres_refinement(ops64: dict, ops32: dict, D, f, g,
                                      tol: float = 1e-8,
                                      inner_maxsteps: int = 800,
                                      inner_tol: float = 1e-5,
                                      max_refine: int = 8,
                                      abs_test: bool = True, group=None):
    """Refinement with f32 MINRES inner solves on the equilibrated saddle
    system (``D``: the equilibration of :func:`equilibrated_f32_ops`).

    Preconditioned MINRES has none of the Bramble-Pasciak transform's
    (A preA - I) cancellation in f32: its per-solve true-residual floor is
    about 1e-3 and stable, so three to four passes reach 1e-8.
    ``abs_test``: the inner MINRES's absolute stopping test, True by
    default as in the JAX package -- it stops a pass as soon as the
    ABSOLUTE preconditioned residual clears ``inner_tol``, which floors the
    driver near 4e-7; refinement to a deep tolerance passes
    :data:`DEEP_ABS_TEST`.  ``group``: see the module docstring.

    Returns (x, rel_residual, refinement_steps, total_inner_iterations)."""
    outer = _Outer(ops64, f, g, group)
    x, _, r, steps, its = _refine(
        outer, tol, max_refine,
        _minres_f32(ops32, D, inner_tol, inner_maxsteps, abs_test, group))
    return x, r, steps, its


def mixed_precision_minres_refinement_2phase(ops64: dict, ops32: dict, D, f,
                                             g, tol: float = 1e-8,
                                             inner_maxsteps: int = 800,
                                             inner_tol: float = 1e-5,
                                             max_refine: int = 8,
                                             p2_inner_tol: float = 1e-4,
                                             p2_inner_maxsteps: int = 600,
                                             max_p2: int = 6, group=None):
    """:func:`mixed_precision_minres_refinement` (inner ``abs_test`` =
    :data:`DEEP_ABS_TEST`) plus the bench's phase-2 endgame: once the f32
    passes stall near their floor, MINRES refinement passes on the
    EQUILIBRATED correction system (D A D) dz = D r with the operators of
    ``ops64`` in f64 and f32 casts of the phase-1 preconditioner, each kept
    only when it lowers the residual by 10%.  Posed on the residual, the
    f32 preconditioner noise stays relative and each pass contracts the
    true residual toward the target.  ``ops64`` may be native f64
    operators, or the compensated double-single kernels wrapped back to
    the unscaled system (the JAX bench's substitute).  ``group``: see the
    module docstring.

    Returns (x, rel_residual, (p1_passes, p2_passes), total_inner)."""
    outer = _Outer(ops64, f, g, group)
    x, rv, _, steps1, inner1 = _refine(
        outer, tol, max_refine,
        _minres_f32(ops32, D, inner_tol, inner_maxsteps, DEEP_ABS_TEST,
                    group))

    A64, B64, BT64 = ops64["A"], ops64["B"], ops64["BT"]
    preA32, preM32 = ops32["preA"], ops32["preM"]

    def K64eq(z):
        u, p = z
        Du = D * u
        return (D * A64(Du) + D * BT64(p), B64(Du))

    def pre64(z):
        return (preA32(z[0].to(F32)).to(F64), preM32(z[1].to(F32)).to(F64))

    def inner2(r0, r1):
        res = minres(K64eq, (D * r0, r1), pre=pre64, tol=p2_inner_tol,
                     maxsteps=p2_inner_maxsteps, abs_test=DEEP_ABS_TEST,
                     group=group)
        return (D * res.x[0], res.x[1]), res.iterations

    x, _, r, steps2, inner2_total = _refine(outer, tol, max_p2, inner2,
                                            factor=0.9, start=(x, rv))
    return x, r, (steps1, steps2), inner1 + inner2_total


def solve_initial_refined(model64, model32, tol: float = 1e-8,
                          inner_tol: float = 1e-4,
                          inner_maxsteps: int = 2000, max_refine: int = 8,
                          scale_k=None):
    """Mixed-precision SolveInitial for a model pair.

    ``model64`` / ``model32`` are the same model built in float64 /
    float32 (the flat-vector interface: ``A``, ``B``, ``BT``, ``A_raw``,
    ``B_raw``, ``preA``, ``preM``, ``f``, ``u_bc``, ``free`` -- the 3D
    ``NavierStokesMCS`` and ``NavierStokesHDG3D``).  The f32
    Bramble-Pasciak floor of the condensed MCS operator is about 1e-5, so
    ``inner_tol`` defaults to 1e-4 (about 4 digits per pass).
    ``scale_k``: the inner BPCG's scaling (:func:`mixed_precision_saddle_
    solve`).  Updates model64's (u, p) state and
    ``stokes_bpcg_iterations``; returns (rel_residual, passes,
    total_inner_iterations)."""
    m64, m32 = model64, model32
    ops64 = dict(A=m64.A, B=m64.B, BT=m64.BT)
    ops32 = dict(A=m32.A, B=m32.B, BT=m32.BT, preA=m32.preA, preM=m32.preM)
    f_mod = torch.where(m64.free, m64.f - m64.A_raw(m64.u_bc), 0.0)
    g_mod = -m64.B_raw(m64.u_bc)
    x, r, steps, inner = mixed_precision_saddle_solve(
        ops64, ops32, f_mod, g_mod, tol=tol, inner_tol=inner_tol,
        inner_maxsteps=inner_maxsteps, max_refine=max_refine,
        scale_k=scale_k)
    m64.u = m64.u_bc + x[0]
    m64.p = x[1]
    m64.stokes_bpcg_iterations = int(inner)
    return float(r), int(steps), int(inner)

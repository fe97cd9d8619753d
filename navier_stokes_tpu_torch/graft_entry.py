"""Entry points: one fused time step, and the multi-rank dry run.

Counterpart of ``__graft_entry__.py``:

* :func:`entry` returns one IMEX time step of the 2D MCS model at maxh
  0.25 (upwind-DG convection, the condensed M* CG, the divergence-free
  projection) and its example argument.  Its element applies run kernel 8
  (``ops/local_mv.batched_local_matvec``) in float32.
* :func:`dryrun_multichip` runs the production solve sharded over
  ``n_ranks`` ranks of ``torch.distributed``
  (:func:`spatial_half`: the split-f32 equilibrated MINRES refinement on
  face-sharded vectors with block-row halo exchange,
  ``parallel/faceshard.py``), then a batch of Taylor-Hood steps split
  over the ranks (:func:`data_parallel_half`, data parallelism).

The JAX function makes its n devices on a CPU by setting ``XLA_FLAGS``
(``--xla_force_host_platform_device_count``) and pinning
``jax_platforms`` before the backend starts; that provisioning has no
counterpart here.  The port starts ranks instead: one in this process for
a world of one (:func:`~.parallel.sharding.single_rank`), else
``n_ranks`` spawned processes (:class:`~.parallel.sharding.Ranks`), on
NCCL where each rank has a card of its own and on gloo otherwise (the
CPU, or more ranks than cards).

    python -m navier_stokes_tpu_torch.graft_entry [--device cpu]

runs one step of :func:`entry` and prints its shape.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .device import resolve_device
from .flagship import uin as uin3
from .mesh.generators import (
    channel_with_cylinder_mesh,
    channel_with_cylinder_mesh_3d,
)
from .models import NavierStokes, NavierStokesMCS
from .parallel.sharding import (
    DeviceMesh,
    Ranks,
    sharded_batch_step,
    single_rank,
)
from .scripts.navier_stokes_2d import uin as uin2

__all__ = ["entry", "dryrun_multichip", "spatial_half",
           "data_parallel_half", "data_parallel_rank"]

# __graft_entry__.py's settings
ENTRY_MAXH = 0.25
DRYRUN_MAXH = 0.35
DRYRUN_SOLVE = dict(tol=1e-8, inner_tol=5e-7, inner_maxsteps=800)
CHANNEL = dict(nu=0.001, inflow="inlet", outflow="outlet", wall="wall|cyl",
               order=2)


def _make_model(maxh: float = 0.2, dtype=torch.float32, device=None):
    """The 2D Taylor-Hood channel with cylinder (dt 1e-3)."""
    return NavierStokes(channel_with_cylinder_mesh(maxh), uin=uin2,
                        timestep=1e-3, dtype=dtype, device=device, **CHANNEL)


def _make_mcs_model(maxh: float = 0.25, dtype=torch.float32, device=None):
    """The 2D MCS channel with cylinder (dt 1e-3, auxspace)."""
    return NavierStokesMCS(channel_with_cylinder_mesh(maxh), uin=uin2,
                           timestep=1e-3, dtype=dtype, device=device,
                           **CHANNEL)


def _make_mcs_model_3d(maxh: float = 0.35, dtype=torch.float32,
                       device=None):
    """The straight 3D MCS channel with cylinder (dt 2e-3, faceblock)."""
    return NavierStokesMCS(channel_with_cylinder_mesh_3d(maxh), uin=uin3,
                           timestep=2e-3, dtype=dtype, device=device,
                           preconditioner="faceblock", **CHANNEL)


def entry(device=None):
    """(step, (u,)): one IMEX time step of the 2D MCS model at maxh 0.25 in
    float32 (``make_step_fn()`` at its defaults, as the JAX function) and
    the model's state.  ``step.model`` is the model, whose
    ``last_iterations`` hold the last step's CG counts."""
    model = _make_mcs_model(ENTRY_MAXH, device=resolve_device(device))
    step = model.make_step_fn()
    step.model = model
    return step, (model.u,)


def spatial_half(mesh, device=None) -> dict:
    """The dry run's spatial half on ``mesh`` (a :class:`DeviceMesh` of
    this process, every rank calling this, or :class:`Ranks` to start):
    the float64 3D MCS model's ``sharded_fast_flagship_solve`` with the
    JAX function's settings, built on ``device`` (default: the mesh's).
    Raises unless the relative residual reaches 1e-8.  Prints the JAX
    function's line and returns its numbers."""
    from .parallel.faceshard import sharded_fast_flagship_solve

    if device is None:
        device = mesh.device if isinstance(mesh, DeviceMesh) else (
            mesh.device or "cuda")
    n = mesh.world_size
    t0 = time.perf_counter()
    model = _make_mcs_model_3d(DRYRUN_MAXH, dtype=torch.float64,
                               device=resolve_device(device))
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    (_, _), rel, passes, inner, plan = sharded_fast_flagship_solve(
        model, mesh, **DRYRUN_SOLVE)
    t_solve = time.perf_counter() - t0
    if not rel <= DRYRUN_SOLVE["tol"]:
        raise RuntimeError(f"sharded 2-phase refinement stalled at {rel}")
    n_halo = sum(len(h) for h in plan.halo_faces)
    nface = model.mesh.nface
    print(f"  3D MCS split-f32 SHARDED solve: ndof={model.n} rel={rel:.2e} "
          f"inner={inner} ({passes[0]} f32 + {passes[1]} f64-endgame "
          f"refinement passes); halo {n_halo / n:.0f} face rows/shard vs "
          f"{nface / n:.0f} owned ({n_halo / nface / n:.1%} halo ratio)",
          flush=True)
    return dict(ndof=model.n, rel=rel, inner=inner, passes=tuple(passes),
                halo_rows=[len(h) for h in plan.halo_faces],
                own_rows=[len(o) for o in plan.own_faces],
                halo_per_shard=n_halo / n, owned_per_shard=nface / n,
                model_seconds=t_model, solve_seconds=t_solve,
                run_stats=plan.run_stats)


def data_parallel_rank(mesh: DeviceMesh) -> dict:
    """Rank body of :func:`data_parallel_half`: the float32 Taylor-Hood
    model at maxh 0.25 on this rank's device, its ``make_step_fn()`` over a
    batch of ``world_size`` copies of ``u`` split across the ranks
    (:func:`~.parallel.sharding.sharded_batch_step`).  Returns the
    gathered batch ``out``, the step's CG counts on this rank and this
    rank's kernel launches in the batch step."""
    from .ops.block_mv import LAUNCHES, reset_launches

    model = _make_model(ENTRY_MAXH, device=mesh.device)
    step = model.make_step_fn()
    batch = torch.stack([model.u] * mesh.world_size)
    reset_launches()
    out = sharded_batch_step(step, mesh)(batch)
    if tuple(out.shape) != (mesh.world_size, model.V.ndof):
        raise RuntimeError(f"sharded batch step: shape {tuple(out.shape)}, "
                           f"expected {(mesh.world_size, model.V.ndof)}")
    return dict(out=out, iterations=dict(model.last_iterations),
                launches=dict(LAUNCHES))


def data_parallel_half(mesh) -> dict:
    """The dry run's data-parallel half on ``mesh`` (a :class:`DeviceMesh`
    of this process or :class:`Ranks` to start): rank 0's result of
    :func:`data_parallel_rank`."""
    if isinstance(mesh, Ranks):
        return mesh.run(data_parallel_rank)
    return data_parallel_rank(mesh)


def dryrun_multichip(n_ranks: int, device=None) -> dict:
    """Both halves of the dry run over ``n_ranks`` ranks, each rank on
    ``device`` (default: CUDA, one card per rank where there are enough,
    else the ranks share them over gloo; ``"cpu"``: gloo ranks on the CPU).
    Prints the JAX function's lines and returns their numbers: the
    spatial half's dict with the data-parallel half's ``batch_shape``,
    ``batch_iterations`` and ``batch_launches`` (rank 0's) added."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    if n_ranks == 1:
        mesh = single_rank("nccl" if cuda else "gloo", device=device)
    elif cuda and torch.cuda.device_count() >= n_ranks:
        mesh = Ranks(n_ranks, backend="nccl")
    elif cuda:
        mesh = Ranks(n_ranks, backend="gloo", device="cuda:0")
    else:  # the CPU's cores shared out among the ranks
        mesh = Ranks(n_ranks, backend="gloo", device="cpu",
                     threads=max(1, (os.cpu_count() or 1) // n_ranks))
    try:
        out = spatial_half(mesh, device)
        batch = data_parallel_half(mesh)
    finally:
        if n_ranks == 1:
            torch.distributed.destroy_process_group()
    out.update(batch_shape=tuple(batch["out"].shape),
               batch_iterations=batch["iterations"],
               batch_launches=batch["launches"])
    print(f"dryrun_multichip({n_ranks}): split-f32 sharded 3D MCS solve "
          f"(face-sharded production path, {out['inner']} inner its to rel "
          f"{out['rel']:.1e}) + sharded ensemble step OK", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, required)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    if out.device.type == "cuda":
        torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("entry(): the step is not finite")
    print("entry() compile+run OK, out shape", tuple(out.shape))
    return 0


if __name__ == "__main__":
    sys.exit(main())

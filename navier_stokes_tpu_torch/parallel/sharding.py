"""Multi-rank execution on ``torch.distributed``: the handle of a process
group, element-sharded operators, batch-sharded sweeps and the launcher of
rank processes.

Counterpart of ``navier_stokes_tpu/parallel/sharding.py``.  The JAX
package runs every shard of a device mesh inside one program (jit +
NamedSharding, or ``shard_map``) on one flat vector, and XLA inserts the
collectives.  The port runs one process per rank: each holds its own block
of the flat layout, and the collectives are explicit --
``jax.lax.all_gather`` becomes :meth:`DeviceMesh.all_gather`,
``jax.lax.psum`` :meth:`DeviceMesh.all_reduce`, and a Krylov inner product
a local dot and one ``all_reduce`` (the ``group`` argument of the drivers,
``linalg/pytree.tdot``).

* :func:`device_mesh` -- the handle (rank, world size, device, backend) of
  an initialised process group; rank r runs on ``cuda:(r % device
  count)`` unless the caller asks for the CPU.  NCCL carries the
  collectives for one rank per card; gloo for the CPU and for several
  ranks on one card, where the port stages CUDA tensors through host
  memory itself (NCCL refuses two ranks on one GPU).
* :func:`pad_elements`, :func:`sharded_local_operator` -- each rank applies
  its slice of the element tables through kernel 8
  (``ops/local_mv.batched_local_matvec``) and a
  :class:`~navier_stokes_tpu_torch.ops.assembly.ScatterPlan`, then one
  ``all_reduce`` gives every rank the global product.
* :func:`sharded_batch_step` -- each rank advances its contiguous share of
  a batch; the results are gathered in the batch's order.
* :func:`launch` -- spawns ``world_size`` rank processes (the ``spawn``
  start method: CUDA cannot fork), runs a module-level function in each and
  returns rank 0's result; :class:`Ranks` -- the same as a mesh argument of
  the sharded solves, which then start their ranks from the calling
  process; :func:`single_rank` -- a one-rank group in this process, on an
  in-memory store.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from ..ops.assembly import ScatterPlan
from ..ops.local_mv import batched_local_matvec

__all__ = ["COLLECTIVES", "DeviceMesh", "Ranks", "device_mesh",
           "single_rank", "pad_elements", "sharded_local_operator",
           "local_operator_rank", "sharded_batch_step", "batch_step_rank",
           "share", "gather_rows", "fresh_table", "launch"]

# collective calls of this process, by kind (reset by the caller)
COLLECTIVES = {"all_gather": 0, "all_reduce": 0}


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """This rank's view of an initialised process group: ``rank`` of
    ``world_size``, the ``device`` its tensors live on, the ``backend``
    (``"nccl"`` or ``"gloo"``) and the mesh ``axis`` name.  ``shape`` maps
    the axis to the world size, as a JAX mesh's does."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    axis: str = "shard"

    @property
    def shape(self) -> dict:
        return {self.axis: self.world_size}

    def _staged(self, t: torch.Tensor) -> bool:
        # gloo's collectives take host tensors: the port copies CUDA
        # tensors to the host and back itself
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (``jax.lax.psum``), as a new
        tensor on ``t``'s device."""
        COLLECTIVES["all_reduce"] += 1
        staged = self._staged(t)
        buf = t.cpu() if staged else t.clone()
        dist.all_reduce(buf)
        return buf.to(t.device) if staged else buf

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world_size, *t.shape): every rank's ``t`` in rank order
        (``jax.lax.all_gather``), on ``t``'s device."""
        COLLECTIVES["all_gather"] += 1
        staged = self._staged(t)
        src = (t.cpu() if staged else t).contiguous()
        out = src.new_empty((self.world_size,) + tuple(src.shape))
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, src)
        else:
            dist.all_gather(list(out.unbind(0)), src)
        return out.to(t.device) if staged else out


@dataclasses.dataclass(frozen=True)
class Ranks:
    """Rank processes to start for a sharded solve (:func:`launch`'s
    arguments): ``world_size`` ranks on ``backend``, each on ``device``
    (None: one CUDA device per rank), with ``threads`` torch and BLAS
    threads each.  ``shape`` maps ``axis`` to the world size, as a mesh's
    does."""

    world_size: int
    backend: str = "gloo"
    device: object = None
    threads: int | None = None
    timeout: float = 900.0
    axis: str = "shard"

    @property
    def shape(self) -> dict:
        return {self.axis: self.world_size}

    def run(self, target, *args, rank_args=None):
        """:func:`launch` of ``target`` on these ranks."""
        return launch(target, self.world_size, *args, backend=self.backend,
                      device=self.device, rank_args=rank_args,
                      threads=self.threads, timeout=self.timeout)


def device_mesh(n_devices: int | None = None, axis: str = "shard",
                device=None) -> DeviceMesh:
    """The handle of the initialised default process group for this rank.

    ``n_devices``: the world size expected (None: whatever it is).
    ``device``: where this rank's tensors live; by default
    ``cuda:(rank % torch.cuda.device_count())``, and without a GPU this
    raises rather than carrying on on the CPU (pass ``device="cpu"``)."""
    if not dist.is_initialized():
        raise RuntimeError("device_mesh: no process group; start the ranks "
                           "with launch() or single_rank(), or call "
                           "torch.distributed.init_process_group")
    rank, ws = dist.get_rank(), dist.get_world_size()
    if n_devices not in (None, ws):
        raise ValueError(f"device_mesh: {n_devices} devices asked, the "
                         f"group has {ws} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device_mesh: no CUDA device available; pass "
                               "device='cpu' to run the ranks on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_mesh: CUDA device requested but none "
                               "is available")
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = str(dist.get_backend())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("device_mesh: NCCL needs CUDA tensors")
    return DeviceMesh(rank, ws, device, backend, axis)


def single_rank(backend: str = "nccl", device=None,
                axis: str = "shard") -> DeviceMesh:
    """A process group of one rank in this process, on an in-memory store
    (no address, no port), and its handle.  The caller ends it with
    ``torch.distributed.destroy_process_group()``."""
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    return device_mesh(1, axis, device)


def fresh_table(a, device, dtype=None) -> torch.Tensor:
    """A contiguous copy of ``a`` (numpy or tensor) in a FRESH allocation on
    ``device``: the kernels' bulk copies need their tables on a 16-byte
    boundary, which a slice of a larger table may not be."""
    t = torch.as_tensor(a)
    out = torch.empty(tuple(t.shape), dtype=dtype or t.dtype, device=device)
    out.copy_(t)
    return out


def pad_elements(a_local, eldofs, n_shards: int):
    """Pad the element axis to a multiple of ``n_shards``.

    Padding elements carry zero local matrices and scatter into dof 0, so
    they contribute nothing."""
    a_local, eldofs = torch.as_tensor(a_local), torch.as_tensor(eldofs)
    pad = (-a_local.shape[0]) % n_shards
    if pad:
        a_local = torch.cat([a_local, a_local.new_zeros(
            (pad,) + tuple(a_local.shape[1:]))])
        eldofs = torch.cat([eldofs, eldofs.new_zeros(
            (pad,) + tuple(eldofs.shape[1:]))])
    return a_local, eldofs


def sharded_local_operator(a_local, eldofs, ndof: int, mesh: DeviceMesh,
                           axis: str = "shard"):
    """Element-sharded matrix-free apply: u (replicated) -> A u
    (replicated).

    The padded element tables are split in contiguous slices over the
    ranks; each rank applies its slice (gather, kernel 8, ``ScatterPlan``)
    and one ``all_reduce`` sums the partial products."""
    n_shards = mesh.shape[axis]
    a_local, eldofs = pad_elements(a_local, eldofs, n_shards)
    per = a_local.shape[0] // n_shards
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    a = fresh_table(a_local[rows], mesh.device)
    plan = ScatterPlan(fresh_table(eldofs[rows], mesh.device, torch.long),
                       ndof)

    def apply(u):
        ye = batched_local_matvec(a, u[plan.index].contiguous())
        return mesh.all_reduce(plan(ye))

    apply.table = a
    return apply


def local_operator_rank(mesh: DeviceMesh, a_local, eldofs, ndof: int, u,
                        free, rhs, tol: float = 1e-10, maxsteps: int = 500):
    """Rank body: the element-sharded operator of (``a_local``,
    ``eldofs``) applied to ``u``, and PCG (every inner product summed over
    the ranks) on the system masked to the ``free`` dofs (identity on the
    others) from ``rhs``.  Every vector is replicated.  Returns (A u, the
    CG solution, its iterations, converged)."""
    from ..solvers.cg import cg

    dev = mesh.device
    A = sharded_local_operator(a_local, eldofs, ndof, mesh)
    u, rhs = (torch.as_tensor(v, device=dev) for v in (u, rhs))
    free = torch.as_tensor(free, device=dev)

    def A_masked(v):
        return torch.where(free, A(torch.where(free, v, 0.0)), v)

    # the vectors are replicated: the local dot is already the global one
    res = cg(A_masked, rhs, tol=tol, maxsteps=maxsteps)
    return A(u), res.x, res.iterations, res.converged


def share(n_items: int, mesh: DeviceMesh) -> tuple[int, int]:
    """[lo, hi): this rank's contiguous share of ``n_items``."""
    r, n = mesh.rank, mesh.world_size
    return r * n_items // n, (r + 1) * n_items // n


def gather_rows(mesh: DeviceMesh, rows: torch.Tensor,
                n_items: int) -> torch.Tensor:
    """(n_items, ...) on every rank from each rank's rows of its
    :func:`share`, in item order: one ``all_gather`` of the shares padded
    to the largest."""
    n = mesh.world_size
    width = -(-n_items // n)
    pad = rows.new_zeros((width,) + tuple(rows.shape[1:]))
    pad[: rows.shape[0]] = rows
    every = mesh.all_gather(pad)
    sizes = [(r + 1) * n_items // n - r * n_items // n for r in range(n)]
    return torch.cat([every[r, : sizes[r]] for r in range(n)])


def sharded_batch_step(step_fn, mesh: DeviceMesh, axis: str = "shard"):
    """``run(batch_u)``: ``step_fn`` over a leading batch axis split across
    the ranks -- each rank advances its contiguous share of the members,
    one after the other, and the results are gathered in the batch's order
    on every rank (the JAX function vmaps ``step_fn`` over the sharded
    axis)."""
    del axis  # one mesh axis: the world

    def run(batch_u):
        batch_u = torch.as_tensor(batch_u, device=mesh.device)
        lo, hi = share(batch_u.shape[0], mesh)
        mine = [step_fn(batch_u[i]) for i in range(lo, hi)]
        rows = (torch.stack(mine) if mine else
                batch_u.new_zeros((0,) + tuple(batch_u.shape[1:])))
        return gather_rows(mesh, rows, batch_u.shape[0])

    return run


def batch_step_rank(mesh: DeviceMesh, step_fn, batch_u):
    """Rank body: :func:`sharded_batch_step` of ``step_fn`` (a picklable
    callable) on ``batch_u``."""
    return sharded_batch_step(step_fn, mesh)(batch_u)


# -- the launcher ---------------------------------------------------------


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _to_cpu(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(_to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def _rank_main(rank, world_size, init_file, backend, device, timeout,
               threads, target, rank_arg, args, out):
    """One rank: join the group, run ``target(mesh, [rank_arg,] *args)``,
    rank 0 puts the result (tensors on the host) on ``out``.  An exception
    ends the process with a non-zero exit code."""
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout))
    try:
        mesh = device_mesh(world_size, device=device)
        extra = () if rank_arg is None else (rank_arg,)
        result = target(mesh, *extra, *args)
        if rank == 0:
            # plain pickle bytes: a tensor put as is would travel as a
            # shared-memory handle that dies with this process
            out.put(pickle.dumps(_to_cpu(result)))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(target, world_size: int, *args, backend: str = "gloo",
           device=None, rank_args=None, threads: int | None = None,
           timeout: float = 900.0):
    """Run ``target(mesh, [rank_args[r],] *args)`` in ``world_size`` rank
    processes and return rank 0's result (its tensors on the host).

    ``target`` must be a module-level function of an importable module
    (the children start from a fresh interpreter and import it by name).
    ``device``: each rank's device (:func:`device_mesh`'s default: one CUDA
    device per rank modulo the device count); the kernels are built here,
    once, before the ranks start.  ``backend``: ``"nccl"`` (one rank per
    card) or ``"gloo"`` (the CPU, or several ranks on one card).
    ``threads``: torch and BLAS threads per rank.  A rank that fails ends
    the others and raises here; so does a run past ``timeout`` seconds
    (which also bounds every collective)."""
    import multiprocessing as mp

    want_cuda = device is None or torch.device(device).type == "cuda"
    if want_cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("launch: no CUDA device available; pass "
                               "device='cpu' to run the ranks on the CPU")
        from ..ops.block_mv import build_all

        build_all()
    if rank_args is not None and len(rank_args) != world_size:
        raise ValueError(f"launch: {len(rank_args)} rank arguments for "
                         f"{world_size} ranks")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="nstt_ranks_")
    init_file = os.path.join(tmp, "store")
    env = {"GLOO_SOCKET_IFNAME": os.environ.get("GLOO_SOCKET_IFNAME", "lo")}
    if threads:
        env.update({k: str(threads) for k in (
            "OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")})
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    procs = []
    try:
        for r in range(world_size):
            procs.append(ctx.Process(
                target=_rank_main, daemon=True,
                args=(r, world_size, init_file, backend, device, timeout,
                      threads, target,
                      None if rank_args is None else rank_args[r], args,
                      out)))
            procs[-1].start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.monotonic() + timeout
    result, got = None, False
    try:
        while True:
            if not got:
                try:
                    result, got = pickle.loads(out.get(timeout=0.2)), True
                except queue_mod.Empty:
                    pass
            codes = [p.exitcode for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"launch: rank {bad[0][0]} of "
                                   f"{target.__name__} exited with code "
                                   f"{bad[0][1]}")
            if all(c == 0 for c in codes):
                if not got:
                    try:
                        result = pickle.loads(out.get(timeout=5.0))
                        got = True
                    except queue_mod.Empty:
                        raise RuntimeError("launch: rank 0 returned no "
                                           "result") from None
                break
            if got:
                time.sleep(0.05)
            if time.monotonic() > deadline:
                raise TimeoutError(f"launch: {target.__name__} ran past "
                                   f"{timeout} s")
    finally:
        for p in procs:
            if p.exitcode is None:
                p.terminate()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    return result

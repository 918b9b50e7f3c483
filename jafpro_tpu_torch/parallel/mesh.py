"""Data parallelism over processes (port of ``jafpro_tpu/parallel/mesh.py``).

The JAX package runs one program over a 1-D device mesh: parameters
replicated, the batch sharded on its leading axis, and XLA inserting the
collectives, so the sharded step computes the unsharded step's update on
the global batch. The port keeps the names and that contract with
PyTorch's multi-process idiom: one process (a *rank*) per device, joined
by a ``torch.distributed`` process group, NCCL on CUDA and gloo on the CPU
or when asked. Only ``all_reduce`` and ``broadcast`` touch device tensors:
gloo supports nothing else on CUDA, and gloo is what lets two ranks share
one card.

While a step runs under ``data_parallel_jit`` its mesh is *active*
(``active_mesh()``, a context variable, as JAX's ``with mesh:``), and the
three places where a batch's samples meet take the global batch:

* ``BatchStatsNorm(per_sample=False)`` sums its statistics over every
  rank's shard (``sum_over_ranks``, whose backward carries the other ranks'
  share of the gradient);
* ``bce_masked`` divides by the global count of valid samples;
* ``TrainState.grads`` averages each gradient over the ranks
  (``reduce_gradients``).

Spans (``utils/profiling.py``): ``mesh.reduce`` around
``reduce_gradients`` (``n``: the bytes reduced) and ``mesh.stats`` around
each all-reduce of ``sum_over_ranks``, forward and backward (``n``: 1, the
all-reduces), both on the device's stream.

The convention: each rank's loss is its shard's share, scaled so that the
mean over the ranks is the global-batch loss (a plain mean over an equal
shard already is; ``bce_masked`` scales by the world size). Gradients are
then averaged and the step's metrics are averaged, so every rank applies
the same gradient and logs the same metrics, and the replicas stay bitwise
equal. Without an active mesh nothing changes.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, \
    Sequence

import numpy as np
import torch
import torch.distributed as dist

from jafpro_tpu_torch.utils.profiling import span

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "jafpro_active_mesh", default=None)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a 1-D ``("data",)`` mesh: ``world`` ranks, this
    one ``rank`` on ``device``, joined by the default process group over
    ``backend``."""

    world: int
    rank: int
    device: torch.device
    backend: str
    axis_names: tuple = ("data",)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks in place and return it. A tensor that is
        not on the mesh's device travels through it."""
        if x.device == self.device:
            dist.all_reduce(x)
            return x
        y = x.to(self.device)
        dist.all_reduce(y)
        x.copy_(y)
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``x`` with rank ``src``'s value in place."""
        if x.device == self.device:
            dist.broadcast(x, src)
            return x
        y = x.to(self.device)
        dist.broadcast(y, src)
        x.copy_(y)
        return x

    def barrier(self) -> None:
        """Wait for every rank (an all-reduce of one value on the mesh's
        device, which gloo on CUDA and NCCL both take)."""
        self.all_reduce(torch.zeros(1, device=self.device))


def active_mesh() -> Optional[Mesh]:
    """The mesh of the step running in this context, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make ``mesh`` the active mesh inside the block (None: no mesh)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        with span("mesh.stats", device=True, n=1):
            return mesh.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        # every rank's output is the sum, so each input's gradient is the
        # sum of the outputs' gradients over the ranks
        with span("mesh.stats", device=True, n=1):
            return ctx.mesh.all_reduce(g.clone()), None


def sum_over_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: its backward sums
    the gradient over the ranks too."""
    return _SumOverRanks.apply(x, mesh)


def gather_over_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(world, *x.shape): every rank's ``x``, stacked in rank order, on
    every rank. Built as a zero-padded buffer summed over the ranks (an
    all-reduce, which gloo takes on CUDA where it takes no all-gather);
    ``x`` must have one shape on every rank."""
    buf = torch.zeros((mesh.world,) + tuple(x.shape), dtype=x.dtype,
                      device=mesh.device)
    buf[mesh.rank] = x
    return mesh.all_reduce(buf)


def reduce_gradients(grads: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Average ``grads`` over the ranks in place: one flat buffer per dtype,
    summed, divided by the world size."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    nbytes = sum(g.numel() * g.element_size() for g in grads)
    with span("mesh.reduce", device=True, n=nbytes):
        for gs in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in gs])
            mesh.all_reduce(flat).div_(mesh.world)
            i = 0
            for g in gs:
                g.copy_(flat[i:i + g.numel()].view_as(g))
                i += g.numel()


def create_mesh(n_devices: Optional[int] = None,
                axes: Sequence[str] = ("data",),
                shape: Optional[Sequence[int]] = None, *,
                device=None) -> Mesh:
    """This rank's 1-D ``("data",)`` mesh over the default process group,
    which must be up (``spawn`` or ``initialize_distributed``).
    ``n_devices``, when given, must be the group's size. ``device``
    defaults to ``cuda:<LOCAL_RANK>`` under NCCL and to the CPU under
    gloo; gloo ranks may name a card, and several may share one. Any
    other axes or shape is refused."""
    if tuple(axes) != ("data",):
        raise ValueError(f"the port's mesh is 1-D over ('data',); got axes "
                         f"{tuple(axes)}")
    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh: no process group; start the ranks with "
            "jafpro_tpu_torch.parallel.spawn, or under torchrun call "
            "initialize_distributed() first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"create_mesh({n_devices}): the process group has "
                         f"{world} ranks")
    if shape is not None and tuple(shape) != (world,):
        raise ValueError(f"the port's mesh is 1-D: shape must be ({world},), "
                         f"got {tuple(shape)}")
    backend = str(dist.get_backend())
    if device is None:
        device = (f"cuda:{os.environ.get('LOCAL_RANK', rank)}"
                  if backend == "nccl" else "cpu")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL rank needs a CUDA device, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(world, rank, device, backend)


class ShardedBatch(dict):
    """A batch already cut to this rank's shard (what ``shard_batch``
    returns); ``shard_batch`` passes it through unchanged."""


def shard_batch(mesh: Mesh, batch: Mapping[str, Any],
                axis: str = "data") -> ShardedBatch:
    """This rank's equal slice of every leaf's leading (batch) axis, as
    tensors on the mesh's device (numpy leaves are converted). Refuses a
    batch that the world size does not divide."""
    if isinstance(batch, ShardedBatch):
        return batch
    if axis not in mesh.axis_names:
        raise ValueError(f"no mesh axis {axis!r}")
    out = ShardedBatch()
    for k, v in batch.items():
        if isinstance(v, Mapping):
            out[k] = shard_batch(mesh, v, axis)
            continue
        n = v.shape[0]
        if n % mesh.world:
            raise ValueError(f"batch_size {n} not divisible by "
                             f"--num-devices {mesh.world}")
        m = n // mesh.world
        part = v[mesh.rank * m:(mesh.rank + 1) * m]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        out[k] = part.to(mesh.device)
    return out


def _state_tensors(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors ``replicate`` makes equal, in one order on every rank."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif hasattr(tree, "opts") and hasattr(tree, "params"):  # TrainState
        for name in sorted(tree.params):
            yield from tree.params[name]
            opt = tree.opts[name]
            for p in tree.params[name]:
                for _, v in sorted(opt.state.get(p, {}).items()):
                    if isinstance(v, torch.Tensor):
                        yield v
    elif isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _state_tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _state_tensors(v)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Make every rank's copy of ``tree`` rank 0's: a module's parameters
    and buffers, a ``TrainState``'s parameters and optimizer state, or the
    tensors of a dict or list. In place; returns ``tree``."""
    with torch.no_grad():
        for t in _state_tensors(tree):
            mesh.broadcast(t.data if isinstance(t, torch.nn.Parameter)
                           else t)
    return tree


def _mean_metrics(metrics: Mapping[str, torch.Tensor],
                  mesh: Mesh) -> Dict[str, torch.Tensor]:
    keys = sorted(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).detach().float().to(
        mesh.device) for k in keys])
    vals = mesh.all_reduce(vals) / mesh.world
    return {k: vals[i] for i, k in enumerate(keys)}


def data_parallel_jit(fn: Callable, mesh: Mesh) -> Callable:
    """Wrap ``fn(state, batch) -> (state, metrics)`` for the mesh: the
    wrapper takes the global batch, keeps this rank's ``shard_batch`` of
    it, runs ``fn`` with the mesh active (global batch statistics and
    masked means, gradients averaged over the ranks) and returns metrics
    averaged over the ranks: the global batch's, equal on every rank.
    Nothing is compiled; the name is the JAX package's counterpart's."""
    def wrapper(state, batch):
        batch = shard_batch(mesh, batch)
        with use_mesh(mesh):
            state, metrics = fn(state, batch)
        return state, _mean_metrics(metrics, mesh)

    return wrapper


def initialize_distributed(**kwargs) -> None:
    """``init_process_group`` from the environment ``torchrun`` sets
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL
    where there is a card, gloo elsewhere, unless ``backend=`` says. A
    no-op when the group is already up or ``WORLD_SIZE`` is unset (a
    single process), as the JAX package's is."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    kwargs.setdefault("backend",
                      "nccl" if torch.cuda.is_available() else "gloo")
    kwargs.setdefault("init_method", "env://")
    dist.init_process_group(**kwargs)


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               init_method: str, devices, args: tuple, threads: int,
               out_dir: str, timeout_s: float) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = create_mesh(world, device=devices[rank] if devices else None)
        result = fn(mesh, *args)
        path = os.path.join(out_dir, f"result_{rank}.pt")
        torch.save(result, path + ".tmp")
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *, backend: str = "gloo",
          devices: Optional[Sequence] = None, args: tuple = (),
          threads: Optional[int] = None, workdir: Optional[str] = None,
          timeout_s: float = 1800.0) -> list:
    """Run ``fn(mesh, *args)`` on ``nprocs`` local ranks and return their
    results in rank order.

    Each rank is a process started with ``torch.multiprocessing``'s
    ``spawn`` method (a fresh interpreter: ``fn`` and ``args`` travel
    pickled, ``fn`` by its import path), joined over ``backend`` through
    a ``file://`` rendezvous in a temporary directory under ``workdir``
    (removed at the end). ``devices`` gives each rank's device (the mesh's
    defaults when None); ``threads`` each rank's torch threads (the host's
    cores shared out when None); ``timeout_s`` bounds every collective.
    A rank that raises stops the others and re-raises here."""
    if nprocs < 1:
        raise ValueError("spawn needs at least one rank")
    if devices is not None and len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // nprocs)
    out_dir = tempfile.mkdtemp(prefix="jafpro_ranks_", dir=workdir)
    try:
        init = "file://" + os.path.join(out_dir, "rendezvous")
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, nprocs, backend, init,
                              list(devices) if devices else None, args,
                              threads, out_dir, timeout_s),
            nprocs=nprocs, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"result_{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(nprocs)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

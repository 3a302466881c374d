"""The process-group mesh and every collective of the port.

Port of ``interspeech_ser_tpu/parallel/mesh.py``. The JAX package runs one
controller over a ``Mesh`` of devices and lets GSPMD insert the collectives;
PyTorch runs one process per rank (``torchrun``, or ``torch.multiprocessing``
with an explicit init) over ``torch.distributed``. ``make_mesh`` builds the
mesh that stands for the JAX one: a ``data`` axis and an optional ``model``
axis, the ranks laid out row-major (rank = data_rank x model + model_rank,
as the JAX mesh reshapes its device list), with one process group per row
(the model axis) and per column (the data axis).

Without an initialised process group the mesh has one rank and every helper
here is the identity: no collective runs, and an engine behaves exactly as
its one-device version. Every collective the port issues goes through these
helpers, which report it to ``parallel.audit``.

Data parallelism, as the engines use it:
- ``shard_batch``: the rank's rows of a host batch padded to a multiple of
  the data axis (``batch_sharding`` is that slice);
- ``dropout_rows``: dropout draws the global batch's mask and keeps the
  rank's rows (``ops/attention_core.row_shard``);
- ``gather_rows``: the rows of every rank, concatenated (and cut back to the
  global batch), so that every rank computes the same global loss; its
  backward returns the rank's own slice of the incoming gradient and does
  not sum across ranks, which would scale each gradient by the world size;
- ``all_reduce_grads``: one all-reduce (sum) of the parameters' gradients in
  one flat buffer, once per optimizer step: the one-device gradient;
- ``replicate``: a broadcast of parameters from rank 0 when an engine starts.

gloo takes CUDA tensors for all-reduce and broadcast but not for all-gather:
``gather_rows`` stages that one collective through a host copy, under gloo
only (ranks that share a card, or a run on the CPU, use gloo; one card a rank
uses NCCL, ``utils/device.pick_backend``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..ops import attention_core
from . import audit

AXES = ("data", "model")


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a ``data x model`` mesh and the groups of its axes
    (``None`` for an axis of one rank)."""

    data: int = 1
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None
    backend: Optional[str] = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def rank(self) -> int:
        return self.data_rank * self.model + self.model_rank

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes checkpoints, CSVs and logs."""
        return self.rank == 0

    def main_only(self, fn):
        """``fn`` on rank 0, a no-op on every other rank (a trainer's log)."""
        return fn if self.is_main else _nothing

    def rows(self, n: int) -> int:
        """``n`` rounded up to a multiple of the data axis."""
        return -(-n // self.data) * self.data

    def axis(self, name: str) -> Tuple[int, Any]:
        if name not in AXES:
            raise ValueError(f"axis {name!r}: one of {AXES}")
        return (self.data, self.data_group) if name == "data" else (self.model, self.model_group)


def _nothing(*args, **kwargs) -> None:
    pass


_GROUPS: Dict[Tuple[int, int], Tuple[Any, Any]] = {}


def _groups(world: int, mp: int, rank: int) -> Tuple[Any, Any]:
    """(data group, model group) of ``rank``; every rank creates every group,
    in the same order, as ``new_group`` requires. Cached per process group."""
    key = (id(dist.group.WORLD), mp)
    if key not in _GROUPS:
        data = world // mp
        if mp == 1:
            _GROUPS[key] = (dist.group.WORLD, None)
        elif data == 1:
            _GROUPS[key] = (None, dist.group.WORLD)
        else:
            rows = [dist.new_group([d * mp + m for m in range(mp)]) for d in range(data)]
            cols = [dist.new_group([d * mp + m for d in range(data)]) for m in range(mp)]
            _GROUPS[key] = (cols[rank % mp], rows[rank // mp])
    return _GROUPS[key]


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """The mesh of this process's group: ``model_parallel`` ranks a model
    group, the rest on the data axis. ``n_devices`` (the JAX engines'
    argument) is the number of ranks: ``None`` takes the world (1 without a
    process group); another count than the world's raises, since a process
    cannot add or drop ranks."""
    world = world_size()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide the world of {world} rank(s)")
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but this run has {world} rank(s): launch one process a rank "
                         f"(torchrun --nproc_per_node {n_devices} ...) or pass n_devices=None")
    if world == 1:
        return Mesh()
    rank = dist.get_rank()
    data_group, model_group = _groups(world, model_parallel, rank)
    return Mesh(world // model_parallel, model_parallel, rank // model_parallel, rank % model_parallel,
                data_group, model_group, dist.get_backend())


# -- placement -------------------------------------------------------------


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """The rank's rows of a batch of ``n`` rows padded to ``mesh.rows(n)``."""
    k = mesh.rows(n) // mesh.data
    return slice(mesh.data_rank * k, (mesh.data_rank + 1) * k)


def replicated_sharding(mesh: Mesh) -> slice:
    """Every row: what a replicated array holds on each rank."""
    return slice(None)


def _shard_one(mesh: Mesh, x):
    if x is None:
        return None
    n = x.shape[0]
    sl, rows = batch_sharding(mesh, n), mesh.rows(n)
    if rows > n:
        if isinstance(x, np.ndarray):
            x = np.concatenate([x, np.zeros((rows - n,) + x.shape[1:], x.dtype)])
        else:
            x = torch.cat([x, x.new_zeros((rows - n,) + tuple(x.shape[1:]))])
    return x[sl]


def shard_batch(mesh: Mesh, tree):
    """The rank's rows of each array (numpy or torch) in a list / tuple /
    dict of them, each padded with zero rows to a multiple of the data axis.
    The identity on a data axis of one."""
    if mesh.data == 1:
        return tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, t) for t in tree)
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    return _shard_one(mesh, tree)


def dropout_rows(mesh: Mesh, n: int):
    """Context for a rank's forward over its shard of an ``n``-row global
    batch: every dropout mask is the global batch's, cut to the rank's rows."""
    if mesh.data == 1:
        return contextlib.nullcontext()
    sl = batch_sharding(mesh, n)
    return attention_core.row_shard(sl.start, sl.stop, n)


# -- collectives -------------------------------------------------------------


def _gather(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    n, group = mesh.axis("data")
    staged = mesh.backend == "gloo" and x.is_cuda  # gloo's all_gather takes CPU tensors only
    src = x.detach().contiguous()
    src = src.cpu() if staged else src
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    audit.record("all-gather", src.numel() * n)
    return [p.to(x.device) for p in parts] if staged else parts


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, n):
        ctx.mesh, ctx.local = mesh, x.shape[0]
        out = torch.cat(_gather(mesh, x), dim=0)
        return out if n is None else out[:n]

    @staticmethod
    def backward(ctx, g):
        # every rank computed the same loss from the gathered rows: the rank's
        # own rows' gradient is its slice of g, not the sum over ranks
        k = ctx.local
        start = ctx.mesh.data_rank * k
        out = g.new_zeros((k,) + tuple(g.shape[1:]))
        kept = max(0, min(start + k, g.shape[0]) - start)
        out[:kept] = g[start: start + kept]
        return out, None, None


def gather_rows(mesh: Mesh, x: Optional[torch.Tensor], n: Optional[int] = None):
    """Every rank's rows of ``x`` along dim 0, in rank order, cut to the first
    ``n`` (the global batch without the padding to a mesh multiple).
    Differentiable: the backward keeps the rank's own slice. The identity on
    a data axis of one; ``None`` passes through."""
    if x is None or mesh.data == 1:
        return x if x is None or n is None else x[:n]
    return _GatherRows.apply(x, mesh, n)


def all_reduce(mesh: Mesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """In-place sum of ``x`` over an axis (not differentiable); returns ``x``."""
    n, group = mesh.axis(axis)
    if n == 1:
        return x
    dist.all_reduce(x, group=group)
    audit.record("all-reduce", x.numel())
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(mesh, x.detach().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        # each rank's downstream gradient covers its own rows only: the sum is the whole
        return all_reduce(ctx.mesh, g.contiguous().clone(), ctx.axis), None, None


def all_reduce_sum(mesh: Mesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Differentiable sum over an axis: all-reduce forward and backward (the
    statistics of a synchronised BatchNorm, where each rank's downstream
    gradient is partial)."""
    if mesh.axis(axis)[0] == 1:
        return x
    return _AllReduceSum.apply(x, mesh, axis)


def all_reduce_grads(mesh: Mesh, params: Iterable[torch.Tensor]) -> None:
    """Sum the gradients of ``params`` over the data axis: one all-reduce of
    one flat buffer per dtype. Parameters without a gradient are skipped (the
    same ones on every rank, which run the same graph)."""
    if mesh.data == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = all_reduce(mesh, torch.cat([p.grad.reshape(-1) for p in ps]))
        off = 0
        for p in ps:
            n = p.grad.numel()
            p.grad.copy_(flat[off: off + n].view_as(p.grad))
            off += n


def replicate(mesh: Mesh, params: Union[torch.nn.Module, Sequence[torch.Tensor]]) -> None:
    """Broadcast parameters (a module's parameters and buffers) from rank 0 to
    every rank, in place."""
    if mesh.size == 1:
        return
    tensors = list(params.parameters()) + list(params.buffers()) if isinstance(params, torch.nn.Module) \
        else list(params)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
            audit.record("broadcast", t.numel())


def all_reduce_numbers(mesh: Mesh, values: Sequence[float], axis: str = "data") -> List[float]:
    """The sums of a few host numbers over an axis (float64)."""
    if mesh.axis(axis)[0] == 1:
        return [float(v) for v in values]
    dev = torch.device("cuda", torch.cuda.current_device()) if mesh.backend == "nccl" else torch.device("cpu")
    t = all_reduce(mesh, torch.tensor([float(v) for v in values], dtype=torch.float64, device=dev), axis)
    return t.cpu().tolist()


def barrier(mesh: Mesh) -> None:
    """Every rank of the mesh waits for the others (moves no data: not audited)."""
    if mesh.size > 1:
        dist.barrier()


def data_parallel(mesh: Mesh, fn, inputs: Sequence, n: int):
    """``fn`` over the rank's rows of a global batch of ``n`` rows: its inputs
    sharded (``shard_batch``), its dropout the global batch's
    (``dropout_rows``), its output (a tensor, or a tuple of tensors / None)
    gathered back to the ``n`` rows (``gather_rows``). ``fn(*inputs)`` on a
    data axis of one."""
    if mesh.data == 1:
        return fn(*inputs)
    with dropout_rows(mesh, n):
        out = fn(*shard_batch(mesh, list(inputs)))
    if isinstance(out, tuple):
        return tuple(gather_rows(mesh, o, n) for o in out)
    return gather_rows(mesh, out, n)

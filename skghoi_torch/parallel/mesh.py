"""Data-parallel helpers over the process group of
:mod:`skghoi_torch.parallel.distributed`.

Mirrors ``skghoi_tpu.parallel.mesh``: there one program owns a 1-D ``data``
mesh, the batch is sharded on its leading axis, parameters are replicated,
and XLA inserts the gradient reduction and makes every loss normaliser a
global sum.  Here each process owns one device, so the same three things are
explicit: :func:`shard_batch` (this rank's rows of a global batch),
:func:`replicate` (parameters broadcast from rank 0), and the reductions
(:func:`all_reduce_sum` for the normalisers and the NaN guard's flag,
:func:`all_reduce_mean_` for the gradients, one flat all-reduce per dtype).

Every helper is the identity for a group of one with no process group up,
so single-process callers need no branch.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from skghoi_torch.parallel.distributed import rank, world_size

Tensor = torch.Tensor


def shard_batch(batch, index: Optional[int] = None, count: Optional[int] = None):
    """Rows ``[index*b, (index+1)*b)`` of every tensor of a global batch
    (a ``NamedTuple`` such as ``HOIBatch``, nested ``NamedTuple``\\ s and
    ``None`` leaves included), ``b = rows // count``; defaults to this
    process's rank and the world size."""
    index = rank() if index is None else index
    count = world_size() if count is None else count

    def take(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return type(x)(*map(take, x))
        rows = x.shape[0]
        if rows % count:
            raise ValueError(f"{rows} rows do not split into {count} shards")
        b = rows // count
        return x[index * b:(index + 1) * b]

    return take(batch)


@torch.no_grad()
def replicate(module: nn.Module) -> nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0."""
    if dist.is_initialized():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def all_reduce_sum(t: Tensor) -> Tensor:
    """The sum of ``t`` over the ranks (a new tensor; ``t`` is left alone)."""
    if not dist.is_initialized():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def all_reduce_max(value: int) -> int:
    """The largest of an integer over the ranks (runs on the CPU under gloo,
    on this process's card under NCCL)."""
    if not dist.is_initialized():
        return value
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([value], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place: one flat
    all-reduce for each dtype present."""
    if not dist.is_initialized():
        return
    n = dist.get_world_size()
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(n)
        torch._foreach_copy_(group, [v.view_as(t) for v, t in
                                     zip(flat.split([t.numel() for t in group]), group)])


def all_gather_object(obj: Any) -> List[Any]:
    """``[obj of rank 0, obj of rank 1, ...]`` (``[obj]`` with no group)."""
    if not dist.is_initialized():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out

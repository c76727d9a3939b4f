"""Process-group set-up for data-parallel training over ``torch.distributed``.

Mirrors ``skghoi_tpu.parallel.distributed.initialize``.  The reference
rendezvouses one process per GPU through ``MASTER_ADDR``/``MASTER_PORT`` and
``mp.spawn`` (``configures/.../main.py:26-31,176-179``); here the processes
come from ``torchrun`` (``python -m torch.distributed.run --nproc-per-node N
-m skghoi_torch.tools.train_hicodet ...``), which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.

:func:`initialize` joins the group those variables describe: NCCL for a
process on the card (after ``torch.cuda.set_device(LOCAL_RANK)``), gloo on
the CPU.  A process started without them (a plain ``python -m ...`` run) is
a group of one and :func:`initialize` does nothing; a process that torchrun
started joins a group even at world size 1, so one card runs the NCCL path.
The helpers below answer for a group of one when no group is up.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """Whether the process was started by a launcher that set torchrun's
    variables."""
    return all(k in os.environ for k in _ENV)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def device_for(cpu: bool) -> torch.device:
    """This process's device: the CPU when asked for, else the card of its
    ``LOCAL_RANK`` (``cuda`` alone when no launcher set one)."""
    if cpu:
        return torch.device("cpu")
    return torch.device("cuda", local_rank()) if launched() else torch.device("cuda")


def initialize(device: Union[str, torch.device], init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None) -> bool:
    """Join the process group; returns whether this call started one (its
    caller then ends it with :func:`shutdown`).

    With no arguments the group comes from torchrun's variables, and a
    process without them stays alone; a group already up is kept.
    ``init_method``/``rank``/``world_size`` name a group explicitly (the
    tests use a ``file://`` rendezvous)."""
    if dist.is_initialized():
        return False
    if init_method is None and not launched():
        return False
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group was asked for and no CUDA device is available")
        torch.cuda.set_device(device.index if device.index is not None else local_rank())
    backend = "nccl" if device.type == "cuda" else "gloo"
    if init_method is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    dist.barrier()  # sets up the communicator now, not in the first training step
    return True


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()

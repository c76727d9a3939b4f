"""Checkpoint save and load with the reference's logical keys.

Reference checkpoints are torch dicts with keys ``model_state_dict``,
``optim_state_dict``, ``scheduler_state_dict``, ``epoch``, ``iteration``
(``configures/.../main.py:88-93``, read back by the cache/test/demo entries).
Mirrors ``skghoi_tpu.train.checkpoint`` (orbax there): the schedule is a
function of the step, so its state is ``{"step": iteration}``; the AdamW
state (moments, step counts, and the applied-step count and lr of each
param group) is ``torch.optim.Optimizer.state_dict()``.

Files are written with ``torch.save`` and read with ``weights_only=True``.
:func:`load_model_state` loads a model's weights from either a port
``state_dict`` or a JAX variable tree (``{"params", "batch_stats"}``, scanned
or unrolled ResNet layout), converting the latter through
:func:`skghoi_torch.weights.to_state_dict`, on every path that loads weights.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import torch
from torch import nn

from skghoi_torch.weights import to_state_dict


def save_checkpoint(path: str, model_state: Mapping[str, torch.Tensor], optim_state: Dict[str, Any],
                    epoch: int, iteration: int) -> None:
    """Write the checkpoint to ``path`` (via a temporary file, so a crash
    mid-write leaves no truncated checkpoint under the final name; a write
    that raises, e.g. on a full disk, removes its temporary file)."""
    payload = {
        "model_state_dict": dict(model_state),
        "optim_state_dict": optim_state,
        "scheduler_state_dict": {"step": int(iteration)},
        "epoch": int(epoch),
        "iteration": int(iteration),
    }
    tmp = f"{path}.tmp"
    try:
        torch.save(payload, tmp)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint's dict, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model_state(model: nn.Module, model_state: Mapping) -> None:
    """Load ``model_state`` into ``model`` strictly: a port ``state_dict`` as
    it is, a JAX variable tree through ``to_state_dict``."""
    if "params" in model_state:
        model_state = to_state_dict(model_state)
    model.load_state_dict(model_state, strict=True)

"""Two-group AdamW with the reference's milestone schedule.

Mirrors ``skghoi_tpu.train.optimizer.build_optimizer`` (reference
``configures/hicodet/adamixer_transH_spatial_r50_main.py:108-166``):
parameters under ``detector.`` train at ``lr * lr_decay``, all others at
``lr``; AdamW weight decay on every parameter of a group (optax's ``adamw``
with no mask); the lr drops by ``milestone_gamma`` at each milestone epoch.
Frozen parameters (``requires_grad=False``: the stem and the frozen ResNet
stages) are in no group, and frozen-BN terms are buffers.

The schedule counts *applied* steps, as optax's count in the optimizer state
does: :class:`ScheduledAdamW` keeps the count in each param group (so it is
part of ``state_dict()``) and advances it only in ``step()``, which the train
step's NaN guard skips.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from skghoi_torch import constants as C


class ScheduledAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose groups carry ``base_lr``, ``boundaries``
    (in steps), ``milestone_gamma`` and ``applied_steps``; each ``step()``
    sets ``lr = base_lr * gamma ** (boundaries passed)`` first, as optax's
    ``piecewise_constant_schedule`` gives it at that count."""

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            passed = sum(group["applied_steps"] >= b for b in group["boundaries"])
            group["lr"] = group["base_lr"] * group["milestone_gamma"] ** passed
        loss = super().step(closure)
        for group in self.param_groups:
            group["applied_steps"] += 1
        return loss


def build_optimizer(model: nn.Module, learning_rate: float = C.LEARNING_RATE,
                    lr_decay: float = C.LR_DECAY_BACKBONE, weight_decay: float = C.WEIGHT_DECAY,
                    steps_per_epoch: int = 1,
                    milestones: Sequence[int] = (C.LR_MILESTONE_EPOCH,),
                    milestone_gamma: float = C.LR_MILESTONE_GAMMA) -> ScheduledAdamW:
    """AdamW over ``model``'s trainable parameters in two groups, detector
    (``lr * lr_decay``) and head (``lr``), with the milestone schedule."""
    groups = {"detector": [], "head": []}
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups["detector" if name.startswith("detector.") else "head"].append(p)
    boundaries = [m * steps_per_epoch for m in milestones]
    param_groups = [
        dict(params=params, name=name, base_lr=learning_rate * scale, lr=learning_rate * scale,
             boundaries=boundaries, milestone_gamma=milestone_gamma, applied_steps=0)
        for (name, params), scale in zip(groups.items(), (lr_decay, 1.0)) if params
    ]
    return ScheduledAdamW(param_groups, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                          weight_decay=weight_decay)

"""KGE training losses: margin / sigmoid / softplus, with self-adversarial option.

Mirrors ``skghoi_tpu.kge.losses`` (OpenKE ``module/loss/*``):

- ``MarginLoss(margin)``: ``max(p - n, -margin).mean() + margin``; with
  ``adv_temperature`` the negatives are weighted by ``softmax(-n * T)``
  (detached) before summing over the negative axis.
- ``SigmoidLoss``: ``-(logsigmoid(p).mean() + logsigmoid(-n).mean()) / 2``;
  adversarial variant weights ``logsigmoid(-n)`` by ``softmax(n * T)``.
- ``SoftplusLoss``: ``(softplus(-p).mean() + softplus(n).mean()) / 2`` with the
  analogous adversarial weighting.

``p_score`` is ``[B, 1]`` (or ``[B]``), ``n_score`` ``[B, K]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@dataclass(frozen=True)
class MarginLoss:
    margin: float = 6.0
    adv_temperature: Optional[float] = None

    def __call__(self, p_score: Tensor, n_score: Tensor) -> Tensor:
        hinge = torch.clamp_min(p_score - n_score, -self.margin)
        if self.adv_temperature is not None:
            w = torch.softmax(-n_score * self.adv_temperature, dim=-1).detach()
            return (w * hinge).sum(dim=-1).mean() + self.margin
        return hinge.mean() + self.margin


@dataclass(frozen=True)
class SigmoidLoss:
    adv_temperature: Optional[float] = None

    def __call__(self, p_score: Tensor, n_score: Tensor) -> Tensor:
        pos = F.logsigmoid(p_score).mean()
        if self.adv_temperature is not None:
            w = torch.softmax(n_score * self.adv_temperature, dim=-1).detach()
            neg = (w * F.logsigmoid(-n_score)).sum(dim=-1).mean()
        else:
            neg = F.logsigmoid(-n_score).mean()
        return -(pos + neg) / 2


@dataclass(frozen=True)
class SoftplusLoss:
    adv_temperature: Optional[float] = None

    def __call__(self, p_score: Tensor, n_score: Tensor) -> Tensor:
        pos = F.softplus(-p_score).mean()
        if self.adv_temperature is not None:
            w = torch.softmax(n_score * self.adv_temperature, dim=-1).detach()
            neg = (w * F.softplus(n_score)).sum(dim=-1).mean()
        else:
            neg = F.softplus(n_score).mean()
        return (pos + neg) / 2

"""Loss functions: binary focal loss and the TransH margin-ranking loss.

Mirrors ``skghoi_tpu.ops.losses``:

- ``binary_focal_loss`` (reference ``ops.py:159-211``):
  ``L = |1 - y - alpha| * (|y - x| + eps)^gamma * BCE(x, y)`` on post-sigmoid
  scores;
- ``binary_focal_loss_with_logits``: the same value from raw logits, with the
  numerically stable BCE;
- ``margin_ranking_loss`` (``heads/MarginLoss.py:28-36``, margin 1):
  ``max(p - n, -margin).mean() + margin``.

Each takes an optional boolean ``mask``: padded slots contribute nothing, and
a masked ``mean`` divides by the number of valid entries.
"""

from __future__ import annotations

from typing import Optional

import torch

from skghoi_torch.constants import FOCAL_ALPHA, FOCAL_EPS

Tensor = torch.Tensor


def _reduce(loss: Tensor, mask: Optional[Tensor], reduction: str) -> Tensor:
    if mask is not None:
        loss = torch.where(mask, loss, torch.zeros((), dtype=loss.dtype, device=loss.device))
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        if mask is None:
            return loss.mean()
        return loss.sum() / mask.to(loss.dtype).sum().clamp_min(1.0)
    raise ValueError(f"Unsupported reduction method {reduction}")


def binary_focal_loss(x: Tensor, y: Tensor, alpha: float = FOCAL_ALPHA, gamma: float = 2.0,
                      reduction: str = "mean", eps: float = FOCAL_EPS,
                      mask: Optional[Tensor] = None) -> Tensor:
    """Focal loss on post-sigmoid scores ``x`` against binary labels ``y``."""
    x = x.clamp(eps, 1.0 - eps)
    bce = -(y * torch.log(x) + (1.0 - y) * torch.log(1.0 - x))
    loss = (1.0 - y - alpha).abs() * ((y - x).abs() + eps) ** gamma * bce
    return _reduce(loss, mask, reduction)


def binary_focal_loss_with_logits(logits: Tensor, y: Tensor, alpha: float = FOCAL_ALPHA,
                                  gamma: float = 2.0, reduction: str = "mean",
                                  eps: float = FOCAL_EPS,
                                  mask: Optional[Tensor] = None) -> Tensor:
    """:func:`binary_focal_loss` of ``sigmoid(logits)``, with the stable BCE
    ``max(z, 0) - z*y + log1p(exp(-|z|))``."""
    x = torch.sigmoid(logits)
    bce = logits.clamp_min(0.0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    loss = (1.0 - y - alpha).abs() * ((y - x).abs() + eps) ** gamma * bce
    return _reduce(loss, mask, reduction)


def margin_ranking_loss(positive_scores: Tensor, negative_scores: Tensor, margin: float = 1.0,
                        mask: Optional[Tensor] = None, count: Optional[Tensor] = None) -> Tensor:
    """``max(p - n, -margin).mean() + margin`` over elementwise pairs of
    distance-style scores; with a ``mask`` the mean runs over valid pairs, and
    an all-false mask gives exactly 0 (no margin offset).

    ``count`` replaces the mask's own count of valid pairs as the mean's
    denominator: under data parallelism it is the count over all ranks, and
    each valid pair carries its margin in the sum, so that the ranks' results
    add up to the whole batch's mean."""
    raw = (positive_scores - negative_scores).clamp_min(-margin)
    if mask is None:
        return raw.mean() + margin
    n = mask.to(raw.dtype).sum() if count is None else count
    zero = torch.zeros((), dtype=raw.dtype, device=raw.device)
    return torch.where(mask, raw + margin, zero).sum() / n.clamp_min(1.0)

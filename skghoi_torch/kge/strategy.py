"""Negative-sampling training strategy (OpenKE ``strategy/NegativeSampling.py``).

Mirrors ``skghoi_tpu.kge.strategy``: a model's scores on one positive + K
negatives per example go through a ranking loss, plus optional L2 / L3
regularization.  Both batch kinds are taken: a :class:`TripleBatch` scores
its ``[B, K]`` negative grids, a :class:`CorruptBatch` goes through the
model's folded ``score_one_side``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from skghoi_torch.kge.sampling import Batch, CorruptBatch

Tensor = torch.Tensor


@dataclass(frozen=True)
class NegativeSampling:
    """loss(p_score [B, 1], n_score [B, K]) plus regularization hooks."""

    loss: Callable[[Tensor, Tensor], Tensor]
    regul_rate: float = 0.0
    l3_regul_rate: float = 0.0

    def __call__(self, model, batch: Batch) -> Tensor:
        p_score = model(batch.pos_h, batch.pos_t, batch.pos_r)[:, None]
        if isinstance(batch, CorruptBatch):
            n_score = model.score_one_side(batch.pos_h, batch.pos_t, batch.pos_r,
                                           batch.neg_ent, batch.corrupt_tail)
            ct = batch.corrupt_tail[:, None]
            neg_h = torch.where(ct, batch.pos_h[:, None], batch.neg_ent)
            neg_t = torch.where(ct, batch.neg_ent, batch.pos_t[:, None])
            neg_r = batch.pos_r[:, None].expand_as(batch.neg_ent)
        else:
            n_score = model(batch.neg_h, batch.neg_t, batch.neg_r)
            neg_h, neg_t, neg_r = batch.neg_h, batch.neg_t, batch.neg_r
        loss = self.loss(p_score, n_score)
        if self.regul_rate != 0.0:
            h = torch.cat([batch.pos_h, neg_h.reshape(-1)])
            t = torch.cat([batch.pos_t, neg_t.reshape(-1)])
            r = torch.cat([batch.pos_r, neg_r.reshape(-1)])
            loss = loss + self.regul_rate * model.regularization(h, t, r)
        if self.l3_regul_rate != 0.0:
            loss = loss + self.l3_regul_rate * model.l3_regularization()
        return loss

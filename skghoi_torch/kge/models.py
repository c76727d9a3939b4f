"""KGE models with OpenKE scoring semantics.

Mirrors ``skghoi_tpu.kge.models``.  Only TransH is here so far: the graph head
embeds it for its entity lookup and its (head, tail, relation) score.
"""

from __future__ import annotations

import math

import torch
from torch import nn

Tensor = torch.Tensor


def _l2_normalize(x: Tensor, dim: int = -1, eps: float = 1e-12) -> Tensor:
    """torch ``F.normalize(p=2)``: divide by max(norm, eps)."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def _p_norm(x: Tensor, p: int, dim: int = -1) -> Tensor:
    if p == 1:
        return x.abs().sum(dim=dim)
    if p == 2:
        return torch.sqrt((x * x).sum(dim=dim) + 1e-30)
    return (x.abs() ** p).sum(dim=dim) ** (1.0 / p)


class TransH(nn.Module):
    """TransE on a per-relation hyperplane: ``e - (e.w_r) w_r`` projection.

    OpenKE TransH: the hyperplane normal is L2-normalized and entities are
    projected before the optional score normalization.  Scores are
    distance-like (lower is more plausible).
    """

    def __init__(self, ent_tot: int, rel_tot: int, dim: int = 100, p_norm: int = 1,
                 norm_flag: bool = True):
        super().__init__()
        self.p_norm = p_norm
        self.norm_flag = norm_flag
        self.ent_embeddings = nn.Embedding(ent_tot, dim)
        self.rel_embeddings = nn.Embedding(rel_tot, dim)
        self.norm_vector = nn.Embedding(rel_tot, dim)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """``nn.init.xavier_uniform_`` on each full table, as OpenKE does."""
        for emb in (self.ent_embeddings, self.rel_embeddings, self.norm_vector):
            num, dim = emb.weight.shape
            limit = math.sqrt(6.0 / (num + dim))
            emb.weight.uniform_(-limit, limit, generator=generator)

    @staticmethod
    def _transfer(e: Tensor, w: Tensor) -> Tensor:
        w = _l2_normalize(w)
        return e - (e * w).sum(dim=-1, keepdim=True) * w

    def score(self, h: Tensor, t: Tensor, r: Tensor) -> Tensor:
        """Distance of ``(h, t, r)`` id triples of any (broadcast) shape."""
        re = self.rel_embeddings(r)
        w = self.norm_vector(r)
        hp = self._transfer(self.ent_embeddings(h), w)
        tp = self._transfer(self.ent_embeddings(t), w)
        if self.norm_flag:
            hp, tp, re = _l2_normalize(hp), _l2_normalize(tp), _l2_normalize(re)
        return _p_norm(hp + re - tp, self.p_norm)

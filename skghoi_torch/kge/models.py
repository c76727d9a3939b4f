"""KGE model zoo with OpenKE scoring semantics, as ``nn.Module``s.

Mirrors ``skghoi_tpu.kge.models`` (the reference
``OpenKE/openke/module/model/*``):

- ``score(h, t, r)`` (also ``forward``) is the *training* score the sampling
  strategies consume: distance-like (lower = more plausible) for the
  translational family, similarity-like (higher = better) for the bilinear
  family; with ``margin`` set, a translational model returns
  ``margin - distance`` (OpenKE's ``margin_flag``).
- ``rank_scores(h, t, r)`` is lower-is-better for every model, the convention
  of the link-prediction ranker (``Test.h`` counts ``value < minimal``).
  RESCAL and Analogy rank by their (distance-like) ``score`` directly, fixing
  OpenKE's double negation as the JAX package does.
- ``score_one_side`` scores ``[B, K]`` negatives that each replace one entity
  of the row's positive; models with a folded form gather the positive's
  fixed parts once per row.
- ``rank_all_tails(h, r)`` / ``rank_all_heads(t, r)`` (where JAX has them)
  score ``[C]`` queries against the whole entity table: ``[C, E]``,
  lower-is-better whatever the margin.
- ``regularization(h, t, r)`` mirrors each OpenKE ``regularization``;
  DistMult also has ``l3_regularization``.

Ids may have any (broadcast) leading shape.  Tables are ``nn.Embedding``s
named as OpenKE names them; ``reset_parameters(generator)`` draws
``xavier_uniform_`` on each full table (or the margin/epsilon uniform range)
from an explicit ``torch.Generator``.  Gathers are plain ``nn.Embedding``
lookups: autograd's index-add backward is the adjoint that the JAX package
spells as a one-hot matmul for TransR's transfer matrices.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def _mean_sq(*tensors: Tensor) -> Tensor:
    return sum((t * t).mean() for t in tensors) / len(tensors)


def _xavier_limit(num: int, dim: int) -> float:
    """Bound of ``nn.init.xavier_uniform_`` on an ``[num, dim]`` table."""
    return math.sqrt(6.0 / (num + dim))


class KGEModel(nn.Module):
    """Base: entity/relation totals, seeded table init, rank-score plumbing."""

    LOWER_IS_BETTER = True  # translational default; bilinear models override

    def __init__(self, ent_tot: int, rel_tot: int):
        super().__init__()
        self.ent_tot = ent_tot
        self.rel_tot = rel_tot

    def _init_table(self, name: str, weight: Tensor, generator: Optional[torch.Generator]) -> None:
        """Xavier-uniform on the full table; models with other ranges override."""
        limit = _xavier_limit(*weight.shape)
        weight.uniform_(-limit, limit, generator=generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for name, module in self.named_children():
            if isinstance(module, nn.Embedding):
                self._init_table(name, module.weight, generator)

    def score(self, h: Tensor, t: Tensor, r: Tensor) -> Tensor:  # pragma: no cover
        raise NotImplementedError

    def forward(self, h: Tensor, t: Tensor, r: Tensor) -> Tensor:
        return self.score(h, t, r)

    def rank_scores(self, h: Tensor, t: Tensor, r: Tensor) -> Tensor:
        s = self.score(h, t, r)
        return s if self.LOWER_IS_BETTER else -s

    def score_one_side(self, pos_h: Tensor, pos_t: Tensor, pos_r: Tensor, neg_ent: Tensor,
                       corrupt_tail: Tensor) -> Tensor:
        """Generic form: rebuild the ``[B, K]`` (h, t, r) grids and score them."""
        ct = corrupt_tail[:, None]
        nh = torch.where(ct, pos_h[:, None], neg_ent)
        nt = torch.where(ct, neg_ent, pos_t[:, None])
        return self.score(nh, nt, pos_r[:, None].expand_as(neg_ent))

    def regularization(self, h: Tensor, t: Tensor, r: Tensor) -> Tensor:  # pragma: no cover
        raise NotImplementedError


class _Translational(KGEModel):
    """``margin`` handling shared by TransE/H/R/D: ``score`` is
    ``margin - distance`` when a margin is set, and ``rank_scores`` undoes it."""

    margin: Optional[float]

    def _out(self, dist: Tensor) -> Tensor:
        return self.margin - dist if self.margin is not None else dist

    def rank_scores(self, h, t, r):
        s = self.score(h, t, r)
        return self.margin - s if self.margin is not None else s

    def rank_all_tails(self, h: Tensor, r: Tensor) -> Tensor:
        return self._rank_all(h, r, anchor_is_head=True)

    def rank_all_heads(self, t: Tensor, r: Tensor) -> Tensor:
        return self._rank_all(t, r, anchor_is_head=False)


class TransE(_Translational):
    """``||h + r - t||_p`` with optional L2 normalization (OpenKE TransE)."""

    def __init__(self, ent_tot: int, rel_tot: int, dim: int = 100, p_norm: int = 1,
                 norm_flag: bool = True, margin: Optional[float] = None):
        super().__init__(ent_tot, rel_tot)
        self.dim, self.p_norm, self.norm_flag, self.margin = dim, p_norm, norm_flag, margin
        self.ent_embeddings = nn.Embedding(ent_tot, dim)
        self.rel_embeddings = nn.Embedding(rel_tot, dim)
        self.reset_parameters()

    def score(self, h, t, r):
        he, te, re = self.ent_embeddings(h), self.ent_embeddings(t), self.rel_embeddings(r)
        if self.norm_flag:
            he, te, re = _l2_normalize(he), _l2_normalize(te), _l2_normalize(re)
        return self._out(_p_norm(he + re - te, self.p_norm))

    def score_one_side(self, pos_h, pos_t, pos_r, neg_ent, corrupt_tail):
        # ||h' + r - t|| = ||e' - (t - r)||; ||h + r - t'|| = ||e' - (h + r)||.
        he, te = self.ent_embeddings(pos_h), self.ent_embeddings(pos_t)
        re, ne = self.rel_embeddings(pos_r), self.ent_embeddings(neg_ent)
        if self.norm_flag:
            he, te, re, ne = (_l2_normalize(x) for x in (he, te, re, ne))
        base = torch.where(corrupt_tail[:, None], he + re, te - re)
        return self._out(_p_norm(ne - base[:, None, :], self.p_norm))

    def _rank_all(self, anchor, r, anchor_is_head):
        ents = self.ent_embeddings.weight
        a, re = self.ent_embeddings(anchor), self.rel_embeddings(r)
        if self.norm_flag:
            ents, a, re = _l2_normalize(ents), _l2_normalize(a), _l2_normalize(re)
        base = a + re if anchor_is_head else a - re
        return _p_norm(ents[None] - base[:, None, :], self.p_norm)

    def regularization(self, h, t, r):
        return _mean_sq(self.ent_embeddings(h), self.ent_embeddings(t), self.rel_embeddings(r))


class TransH(_Translational):
    """TransE on a per-relation hyperplane: ``e - (e.w_r) w_r`` projection.

    OpenKE TransH: the hyperplane normal is L2-normalized and entities are
    projected before the optional score normalization.  The graph head embeds
    this module (its entity lookup and its (head, tail, relation) score).
    """

    def __init__(self, ent_tot: int, rel_tot: int, dim: int = 100, p_norm: int = 1,
                 norm_flag: bool = True, margin: Optional[float] = None):
        super().__init__(ent_tot, rel_tot)
        self.dim, self.p_norm, self.norm_flag, self.margin = dim, p_norm, norm_flag, margin
        self.ent_embeddings = nn.Embedding(ent_tot, dim)
        self.rel_embeddings = nn.Embedding(rel_tot, dim)
        self.norm_vector = nn.Embedding(rel_tot, dim)
        self.reset_parameters()

    @staticmethod
    def _transfer(e: Tensor, w: Tensor) -> Tensor:
        w = _l2_normalize(w)
        return e - (e * w).sum(dim=-1, keepdim=True) * w

    def score(self, h, t, r):
        re, w = self.rel_embeddings(r), self.norm_vector(r)
        hp = self._transfer(self.ent_embeddings(h), w)
        tp = self._transfer(self.ent_embeddings(t), w)
        if self.norm_flag:
            hp, tp, re = _l2_normalize(hp), _l2_normalize(tp), _l2_normalize(re)
        return self._out(_p_norm(hp + re - tp, self.p_norm))

    def score_one_side(self, pos_h, pos_t, pos_r, neg_ent, corrupt_tail):
        re, w = self.rel_embeddings(pos_r), self.norm_vector(pos_r)
        ne = self._transfer(self.ent_embeddings(neg_ent), w[:, None, :])
        hp = self._transfer(self.ent_embeddings(pos_h), w)
        tp = self._transfer(self.ent_embeddings(pos_t), w)
        if self.norm_flag:
            hp, tp, re, ne = (_l2_normalize(x) for x in (hp, tp, re, ne))
        base = torch.where(corrupt_tail[:, None], hp + re, tp - re)
        return self._out(_p_norm(ne - base[:, None, :], self.p_norm))

    def _rank_all(self, anchor, r, anchor_is_head):
        w = self.norm_vector(r)[:, None, :]  # [C, 1, dim]
        ents = self._transfer(self.ent_embeddings.weight[None], w)  # [C, E, dim]
        a = self._transfer(self.ent_embeddings(anchor)[:, None, :], w)
        re = self.rel_embeddings(r)[:, None, :]
        if self.norm_flag:
            ents, a, re = _l2_normalize(ents), _l2_normalize(a), _l2_normalize(re)
        base = a + re if anchor_is_head else a - re
        return _p_norm(ents - base, self.p_norm)

    def regularization(self, h, t, r):
        return _mean_sq(self.ent_embeddings(h), self.ent_embeddings(t),
                        self.rel_embeddings(r), self.norm_vector(r))


class TransR(_Translational):
    """Per-relation linear map into relation space, then TransE scoring.

    ``score_chunk`` bounds training memory: scoring gathers one
    ``[dim_e, dim_r]`` matrix per triple, so with it set ``score`` runs over
    chunks of that many triples under activation checkpointing (the
    backward recomputes each chunk instead of storing its gather).
    """

    def __init__(self, ent_tot: int, rel_tot: int, dim_e: int = 100, dim_r: int = 100,
                 p_norm: int = 1, norm_flag: bool = True, rand_init: bool = False,
                 margin: Optional[float] = None, score_chunk: Optional[int] = None):
        super().__init__(ent_tot, rel_tot)
        self.dim_e, self.dim_r, self.p_norm, self.norm_flag = dim_e, dim_r, p_norm, norm_flag
        self.rand_init, self.margin, self.score_chunk = rand_init, margin, score_chunk
        self.ent_embeddings = nn.Embedding(ent_tot, dim_e)
        self.rel_embeddings = nn.Embedding(rel_tot, dim_r)
        self.transfer_matrix = nn.Embedding(rel_tot, dim_e * dim_r)
        self.reset_parameters()

    def _init_table(self, name, weight, generator):
        if name == "transfer_matrix" and not self.rand_init:  # identity maps
            eye = torch.zeros(self.dim_e, self.dim_r)
            n = min(self.dim_e, self.dim_r)
            eye[torch.arange(n), torch.arange(n)] = 1.0
            weight.copy_(eye.reshape(-1).expand_as(weight))
        else:
            super()._init_table(name, weight, generator)

    def _matrices(self, r: Tensor) -> Tensor:
        return self.transfer_matrix(r).reshape(*r.shape, self.dim_e, self.dim_r)

    def _score_direct(self, h, t, r):
        m = self._matrices(r)
        hp = (self.ent_embeddings(h).unsqueeze(-2) @ m).squeeze(-2)
        tp = (self.ent_embeddings(t).unsqueeze(-2) @ m).squeeze(-2)
        re = self.rel_embeddings(r)
        if self.norm_flag:
            hp, tp, re = _l2_normalize(hp), _l2_normalize(tp), _l2_normalize(re)
        return self._out(_p_norm(hp + re - tp, self.p_norm))

    def score(self, h, t, r):
        shape = torch.broadcast_shapes(h.shape, t.shape, r.shape)
        n = math.prod(shape)
        if self.score_chunk is None or n <= self.score_chunk:
            return self._score_direct(h, t, r)
        flat = [x.expand(shape).reshape(-1) for x in (h, t, r)]
        c = self.score_chunk
        parts = [checkpoint(self._score_direct, *(x[i:i + c] for x in flat), use_reentrant=False)
                 for i in range(0, n, c)]
        return torch.cat(parts).reshape(shape)

    def _rank_all(self, anchor, r, anchor_is_head):
        # The relation is fixed along the entity axis: project the whole
        # entity table once per query with one matmul.
        m = self._matrices(r)  # [C, dim_e, dim_r]
        ents_p = self.ent_embeddings.weight[None] @ m  # [C, E, dim_r]
        anchor_p = (self.ent_embeddings(anchor)[:, None, :] @ m)  # [C, 1, dim_r]
        re = self.rel_embeddings(r)[:, None, :]
        if self.norm_flag:
            ents_p, anchor_p, re = _l2_normalize(ents_p), _l2_normalize(anchor_p), _l2_normalize(re)
        diff = anchor_p + re - ents_p if anchor_is_head else ents_p + re - anchor_p
        return _p_norm(diff, self.p_norm)

    def score_one_side(self, pos_h, pos_t, pos_r, neg_ent, corrupt_tail):
        # One transfer matrix per ROW: the K negatives share the relation.
        m = self._matrices(pos_r)  # [B, dim_e, dim_r]
        hp = (self.ent_embeddings(pos_h)[:, None, :] @ m)[:, 0]
        tp = (self.ent_embeddings(pos_t)[:, None, :] @ m)[:, 0]
        ne = self.ent_embeddings(neg_ent) @ m  # [B, K, dim_r]
        re = self.rel_embeddings(pos_r)
        if self.norm_flag:
            hp, tp, re, ne = (_l2_normalize(x) for x in (hp, tp, re, ne))
        base = torch.where(corrupt_tail[:, None], hp + re, tp - re)
        return self._out(_p_norm(ne - base[:, None, :], self.p_norm))

    def regularization(self, h, t, r):
        regul = _mean_sq(self.ent_embeddings(h), self.ent_embeddings(t),
                         self.rel_embeddings(r), self.transfer_matrix(r))
        return regul * regul  # OpenKE TransR squares its regularizer (TransR.py:100)


class TransD(_Translational):
    """Dynamic projection ``normalize(resize(e) + (e . e_p) r_p)`` per triple."""

    def __init__(self, ent_tot: int, rel_tot: int, dim_e: int = 100, dim_r: int = 100,
                 p_norm: int = 1, norm_flag: bool = True, margin: Optional[float] = None):
        super().__init__(ent_tot, rel_tot)
        self.dim_e, self.dim_r, self.p_norm, self.norm_flag = dim_e, dim_r, p_norm, norm_flag
        self.margin = margin
        self.ent_embeddings = nn.Embedding(ent_tot, dim_e)
        self.rel_embeddings = nn.Embedding(rel_tot, dim_r)
        self.ent_transfer = nn.Embedding(ent_tot, dim_e)
        self.rel_transfer = nn.Embedding(rel_tot, dim_r)
        self.reset_parameters()

    def _resize(self, e: Tensor) -> Tensor:
        if self.dim_e == self.dim_r:
            return e
        if self.dim_e > self.dim_r:
            return e[..., : self.dim_r]
        return nn.functional.pad(e, (0, self.dim_r - self.dim_e))

    def _transfer(self, e: Tensor, e_t: Tensor, r_t: Tensor) -> Tensor:
        return _l2_normalize(self._resize(e) + (e * e_t).sum(dim=-1, keepdim=True) * r_t)

    def score(self, h, t, r):
        re, rt = self.rel_embeddings(r), self.rel_transfer(r)
        hp = self._transfer(self.ent_embeddings(h), self.ent_transfer(h), rt)
        tp = self._transfer(self.ent_embeddings(t), self.ent_transfer(t), rt)
        if self.norm_flag:
            hp, tp, re = _l2_normalize(hp), _l2_normalize(tp), _l2_normalize(re)
        return self._out(_p_norm(hp + re - tp, self.p_norm))

    def _rank_all(self, anchor, r, anchor_is_head):
        rt = self.rel_transfer(r)[:, None, :]  # [C, 1, dim_r]
        ents = self._transfer(self.ent_embeddings.weight[None], self.ent_transfer.weight[None], rt)
        a = self._transfer(self.ent_embeddings(anchor)[:, None, :],
                           self.ent_transfer(anchor)[:, None, :], rt)
        re = self.rel_embeddings(r)[:, None, :]
        if self.norm_flag:
            ents, a, re = _l2_normalize(ents), _l2_normalize(a), _l2_normalize(re)
        base = a + re if anchor_is_head else a - re
        return _p_norm(ents - base, self.p_norm)

    def score_one_side(self, pos_h, pos_t, pos_r, neg_ent, corrupt_tail):
        re, rt = self.rel_embeddings(pos_r), self.rel_transfer(pos_r)
        hp = self._transfer(self.ent_embeddings(pos_h), self.ent_transfer(pos_h), rt)
        tp = self._transfer(self.ent_embeddings(pos_t), self.ent_transfer(pos_t), rt)
        ne = self._transfer(self.ent_embeddings(neg_ent), self.ent_transfer(neg_ent),
                            rt[:, None, :])
        if self.norm_flag:
            hp, tp, re, ne = (_l2_normalize(x) for x in (hp, tp, re, ne))
        base = torch.where(corrupt_tail[:, None], hp + re, tp - re)
        return self._out(_p_norm(ne - base[:, None, :], self.p_norm))

    def regularization(self, h, t, r):
        return _mean_sq(self.ent_embeddings(h), self.ent_embeddings(t), self.rel_embeddings(r),
                        self.ent_transfer(h), self.ent_transfer(t), self.rel_transfer(r))


class DistMult(KGEModel):
    """``sum(h * r * t)`` similarity (higher = better).

    ``margin``/``epsilon``, when both given, switch initialization from
    Xavier to uniform in ``±(margin + epsilon) / dim`` (OpenKE
    ``DistMult.py:16-32``; the margin plays no role in scoring).
    """

    LOWER_IS_BETTER = False

    def __init__(self, ent_tot: int, rel_tot: int, dim: int = 100,
                 margin: Optional[float] = None, epsilon: Optional[float] = None):
        super().__init__(ent_tot, rel_tot)
        self.dim, self.margin, self.epsilon = dim, margin, epsilon
        self.ent_embeddings = nn.Embedding(ent_tot, dim)
        self.rel_embeddings = nn.Embedding(rel_tot, dim)
        self.reset_parameters()

    def _init_table(self, name, weight, generator):
        if self.margin is not None and self.epsilon is not None:
            limit = (self.margin + self.epsilon) / self.dim
            weight.uniform_(-limit, limit, generator=generator)
        else:
            super()._init_table(name, weight, generator)

    def score(self, h, t, r):
        return (self.ent_embeddings(h) * self.rel_embeddings(r) * self.ent_embeddings(t)).sum(-1)

    def score_one_side(self, pos_h, pos_t, pos_r, neg_ent, corrupt_tail):
        # Linear in whichever entity is replaced: the other two factors fold.
        he, te, re = self.ent_embeddings(pos_h), self.ent_embeddings(pos_t), self.rel_embeddings(pos_r)
        base = torch.where(corrupt_tail[:, None], he * re, re * te)
        return (self.ent_embeddings(neg_ent) * base[:, None, :]).sum(-1)

    def _rank_all(self, anchor, r):
        # <h*t, r> is symmetric in h/t: one base for both sides, negated.
        base = self.ent_embeddings(anchor) * self.rel_embeddings(r)
        return -(base @ self.ent_embeddings.weight.T)

    def rank_all_tails(self, h, r):
        return self._rank_all(h, r)

    def rank_all_heads(self, t, r):
        return self._rank_all(t, r)

    def regularization(self, h, t, r):
        return _mean_sq(self.ent_embeddings(h), self.ent_embeddings(t), self.rel_embeddings(r))

    def l3_regularization(self):
        return ((self.ent_embeddings.weight.abs() ** 3).sum()
                + (self.rel_embeddings.weight.abs() ** 3).sum())


class ComplEx(KGEModel):
    """Trouillon et al. complex bilinear score (higher = better)."""

    LOWER_IS_BETTER = False

    def __init__(self, ent_tot: int, rel_tot: int, dim: int = 100):
        super().__init__(ent_tot, rel_tot)
        self.dim = dim
        self.ent_re_embeddings = nn.Embedding(ent_tot, dim)
        self.ent_im_embeddings = nn.Embedding(ent_tot, dim)
        self.rel_re_embeddings = nn.Embedding(rel_tot, dim)
        self.rel_im_embeddings = nn.Embedding(rel_tot, dim)
        self.reset_parameters()

    def score(self, h, t, r):
        h_re, h_im = self.ent_re_embeddings(h), self.ent_im_embeddings(h)
        t_re, t_im = self.ent_re_embeddings(t), self.ent_im_embeddings(t)
        r_re, r_im = self.rel_re_embeddings(r), self.rel_im_embeddings(r)
        return (h_re * t_re * r_re + h_im * t_im * r_re + h_re * t_im * r_im
                - h_im * t_re * r_im).sum(-1)

    def _bases(self, a_re, a_im, r_re, r_im, anchor_is_head):
        if anchor_is_head:  # scoring tails: base = h * r
            return a_re * r_re - a_im * r_im, a_im * r_re + a_re * r_im
        return a_re * r_re + a_im * r_im, a_im * r_re - a_re * r_im  # heads: t * conj(r)

    def score_one_side(self, pos_h, pos_t, pos_r, neg_ent, corrupt_tail):
        h_re, h_im = self.ent_re_embeddings(pos_h), self.ent_im_embeddings(pos_h)
        t_re, t_im = self.ent_re_embeddings(pos_t), self.ent_im_embeddings(pos_t)
        r_re, r_im = self.rel_re_embeddings(pos_r), self.rel_im_embeddings(pos_r)
        ct = corrupt_tail[:, None]
        tail_re, tail_im = self._bases(h_re, h_im, r_re, r_im, True)
        head_re, head_im = self._bases(t_re, t_im, r_re, r_im, False)
        base_re, base_im = torch.where(ct, tail_re, head_re), torch.where(ct, tail_im, head_im)
        n_re, n_im = self.ent_re_embeddings(neg_ent), self.ent_im_embeddings(neg_ent)
        return (n_re * base_re[:, None, :] + n_im * base_im[:, None, :]).sum(-1)

    def _rank_all(self, anchor, r, anchor_is_head):
        base_re, base_im = self._bases(
            self.ent_re_embeddings(anchor), self.ent_im_embeddings(anchor),
            self.rel_re_embeddings(r), self.rel_im_embeddings(r), anchor_is_head)
        return -(base_re @ self.ent_re_embeddings.weight.T + base_im @ self.ent_im_embeddings.weight.T)

    def rank_all_tails(self, h, r):
        return self._rank_all(h, r, anchor_is_head=True)

    def rank_all_heads(self, t, r):
        return self._rank_all(t, r, anchor_is_head=False)

    def regularization(self, h, t, r):
        return _mean_sq(self.ent_re_embeddings(h), self.ent_im_embeddings(h),
                        self.ent_re_embeddings(t), self.ent_im_embeddings(t),
                        self.rel_re_embeddings(r), self.rel_im_embeddings(r))


class RESCAL(KGEModel):
    """Bilinear form with a full matrix per relation, ``-h^T W_r t``
    (distance-like; ranked directly)."""

    def __init__(self, ent_tot: int, rel_tot: int, dim: int = 100):
        super().__init__(ent_tot, rel_tot)
        self.dim = dim
        self.ent_embeddings = nn.Embedding(ent_tot, dim)
        self.rel_matrices = nn.Embedding(rel_tot, dim * dim)
        self.reset_parameters()

    def score(self, h, t, r):
        m = self.rel_matrices(r).reshape(*r.shape, self.dim, self.dim)
        tr = (m @ self.ent_embeddings(t).unsqueeze(-1)).squeeze(-1)
        return -(self.ent_embeddings(h) * tr).sum(-1)

    def regularization(self, h, t, r):
        return _mean_sq(self.ent_embeddings(h), self.ent_embeddings(t), self.rel_matrices(r))


class Analogy(KGEModel):
    """ComplEx part + DistMult part; OpenKE's forward is the negated sum
    (distance-like), ranked directly."""

    def __init__(self, ent_tot: int, rel_tot: int, dim: int = 100):
        super().__init__(ent_tot, rel_tot)
        self.dim = dim
        self.ent_re_embeddings = nn.Embedding(ent_tot, dim)
        self.ent_im_embeddings = nn.Embedding(ent_tot, dim)
        self.rel_re_embeddings = nn.Embedding(rel_tot, dim)
        self.rel_im_embeddings = nn.Embedding(rel_tot, dim)
        self.ent_embeddings = nn.Embedding(ent_tot, dim * 2)
        self.rel_embeddings = nn.Embedding(rel_tot, dim * 2)
        self.reset_parameters()

    def score(self, h, t, r):
        h_re, h_im = self.ent_re_embeddings(h), self.ent_im_embeddings(h)
        t_re, t_im = self.ent_re_embeddings(t), self.ent_im_embeddings(t)
        r_re, r_im = self.rel_re_embeddings(r), self.rel_im_embeddings(r)
        comp = (r_re * h_re * t_re + r_re * h_im * t_im + r_im * h_re * t_im
                - r_im * h_im * t_re).sum(-1)
        dist = (self.ent_embeddings(h) * self.ent_embeddings(t) * self.rel_embeddings(r)).sum(-1)
        return -comp - dist

    def regularization(self, h, t, r):
        return _mean_sq(self.ent_re_embeddings(h), self.ent_im_embeddings(h), self.ent_embeddings(h),
                        self.ent_re_embeddings(t), self.ent_im_embeddings(t), self.ent_embeddings(t),
                        self.rel_re_embeddings(r), self.rel_im_embeddings(r), self.rel_embeddings(r))


class SimplE(KGEModel):
    """OpenKE's simplified SimplE: ``(<h,r,t> + <h,r_inv,t>)/2`` (higher = better)."""

    LOWER_IS_BETTER = False

    def __init__(self, ent_tot: int, rel_tot: int, dim: int = 100):
        super().__init__(ent_tot, rel_tot)
        self.dim = dim
        self.ent_embeddings = nn.Embedding(ent_tot, dim)
        self.rel_embeddings = nn.Embedding(rel_tot, dim)
        self.rel_inv_embeddings = nn.Embedding(rel_tot, dim)
        self.reset_parameters()

    def score(self, h, t, r):
        he, te = self.ent_embeddings(h), self.ent_embeddings(t)
        return ((he * self.rel_embeddings(r) * te).sum(-1)
                + (he * self.rel_inv_embeddings(r) * te).sum(-1)) / 2

    def regularization(self, h, t, r):
        return _mean_sq(self.ent_embeddings(h), self.ent_embeddings(t),
                        self.rel_embeddings(r), self.rel_inv_embeddings(r))


class RotatE(KGEModel):
    """Relation as rotation in the complex plane; score = margin - distance."""

    LOWER_IS_BETTER = False

    def __init__(self, ent_tot: int, rel_tot: int, dim: int = 100, margin: float = 6.0,
                 epsilon: float = 2.0):
        super().__init__(ent_tot, rel_tot)
        self.dim, self.margin, self.epsilon = dim, margin, epsilon
        self._ent_range = (margin + epsilon) / (dim * 2)
        self._rel_range = (margin + epsilon) / dim
        self.ent_embeddings = nn.Embedding(ent_tot, dim * 2)
        self.rel_embeddings = nn.Embedding(rel_tot, dim)
        self.reset_parameters()

    def _init_table(self, name, weight, generator):
        limit = self._ent_range if name == "ent_embeddings" else self._rel_range
        weight.uniform_(-limit, limit, generator=generator)

    def _rotation(self, r: Tensor):
        phase = self.rel_embeddings(r) / (self._rel_range / math.pi)
        return torch.cos(phase), torch.sin(phase)

    def distance(self, h, t, r):
        re_r, im_r = self._rotation(r)
        re_h, im_h = self.ent_embeddings(h).chunk(2, dim=-1)
        re_t, im_t = self.ent_embeddings(t).chunk(2, dim=-1)
        re_s = re_h * re_r - im_h * im_r - re_t
        im_s = re_h * im_r + im_h * re_r - im_t
        return torch.sqrt(re_s ** 2 + im_s ** 2 + 1e-30).sum(-1)

    def score(self, h, t, r):
        return self.margin - self.distance(h, t, r)

    def rank_scores(self, h, t, r):
        return self.distance(h, t, r) - self.margin

    @staticmethod
    def _bases(re_a, im_a, re_r, im_r, anchor_is_head):
        if anchor_is_head:  # scoring tails: base = h * r
            return re_a * re_r - im_a * im_r, re_a * im_r + im_a * re_r
        return re_a * re_r + im_a * im_r, im_a * re_r - re_a * im_r  # heads: t * conj(r)

    def score_one_side(self, pos_h, pos_t, pos_r, neg_ent, corrupt_tail):
        # Unit rotations preserve each |.|: both sides reduce to ||e' - base||.
        re_r, im_r = self._rotation(pos_r)
        re_h, im_h = self.ent_embeddings(pos_h).chunk(2, dim=-1)
        re_t, im_t = self.ent_embeddings(pos_t).chunk(2, dim=-1)
        ct = corrupt_tail[:, None]
        tail_re, tail_im = self._bases(re_h, im_h, re_r, im_r, True)
        head_re, head_im = self._bases(re_t, im_t, re_r, im_r, False)
        base_re, base_im = torch.where(ct, tail_re, head_re), torch.where(ct, tail_im, head_im)
        re_n, im_n = self.ent_embeddings(neg_ent).chunk(2, dim=-1)
        d_re, d_im = re_n - base_re[:, None, :], im_n - base_im[:, None, :]
        return self.margin - torch.sqrt(d_re ** 2 + d_im ** 2 + 1e-30).sum(-1)

    def _rank_all(self, anchor, r, anchor_is_head):
        re_r, im_r = self._rotation(r)
        re_a, im_a = self.ent_embeddings(anchor).chunk(2, dim=-1)
        base_re, base_im = self._bases(re_a, im_a, re_r, im_r, anchor_is_head)
        re_e, im_e = self.ent_embeddings.weight.chunk(2, dim=-1)
        d_re, d_im = re_e[None] - base_re[:, None, :], im_e[None] - base_im[:, None, :]
        return torch.sqrt(d_re ** 2 + d_im ** 2 + 1e-30).sum(-1)

    def rank_all_tails(self, h, r):
        return self._rank_all(h, r, anchor_is_head=True)

    def rank_all_heads(self, t, r):
        return self._rank_all(t, r, anchor_is_head=False)

    def regularization(self, h, t, r):
        return _mean_sq(self.ent_embeddings(h), self.ent_embeddings(t), self.rel_embeddings(r))


class HolE(KGEModel):
    """Holographic embeddings: circular correlation of h and t scored by r."""

    LOWER_IS_BETTER = False

    def __init__(self, ent_tot: int, rel_tot: int, dim: int = 100):
        super().__init__(ent_tot, rel_tot)
        self.dim = dim
        self.ent_embeddings = nn.Embedding(ent_tot, dim)
        self.rel_embeddings = nn.Embedding(rel_tot, dim)
        self.reset_parameters()

    @staticmethod
    def _ccorr(a: Tensor, b: Tensor) -> Tensor:
        fa, fb = torch.fft.fft(a, dim=-1), torch.fft.fft(b, dim=-1)
        return torch.fft.ifft(torch.conj(fa) * fb, dim=-1).real

    def score(self, h, t, r):
        corr = self._ccorr(self.ent_embeddings(h), self.ent_embeddings(t))
        return (corr * self.rel_embeddings(r)).sum(-1)

    def regularization(self, h, t, r):
        return _mean_sq(self.ent_embeddings(h), self.ent_embeddings(t), self.rel_embeddings(r))

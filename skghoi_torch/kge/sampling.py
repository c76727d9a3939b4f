"""Negative sampling: device-side corruption + an OpenKE-exact host sampler.

Mirrors ``skghoi_tpu.kge.sampling``.  The reference generates batches in C++
(``Base.cpp:sampling``): each positive train triple gets ``neg_rate``
corrupted copies; head vs tail corruption is chosen uniformly or
Bernoulli-weighted (``bern``), and the corrupted entity is drawn uniformly
from entities that do NOT form a known train triple (``Corrupt.h``).

:func:`sample_batch` and :func:`sample_batch_oneside` draw on the device
from a ``torch.Generator`` there: uniform triple picks, the head/tail
choice, and filtered corruption by rejection.  As in JAX the number of
rejection rounds is fixed (4): after the last round a negative may still be
a known triple, a chance of about ``(degree / E)^4``.

Membership ("is this triple known?") is :class:`TripleSet`, sorted int64
keys ``(h * R + r) * E + t`` searched with ``torch.searchsorted``: exact,
where the JAX package uses a cuckoo hash (``TripleHashSet``, two gathers a
query on the TPU; its exact-match analogue ``lex3_contains`` is a test
oracle there).

:class:`NumpySampler` is a copy of the JAX package's host sampler with
OpenKE-exact filtering; the tester's triple classification draws from it.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

from skghoi_torch.kge.data import KGData

Tensor = torch.Tensor


class TripleBatch(NamedTuple):
    """Positive triples + per-positive negatives, all ``[B]`` / ``[B, K]``."""

    pos_h: Tensor
    pos_t: Tensor
    pos_r: Tensor
    neg_h: Tensor  # [B, K]
    neg_t: Tensor
    neg_r: Tensor


class CorruptBatch(NamedTuple):
    """One-side-corrupted batch: each row's K negatives replace the SAME
    entity slot (tail where ``corrupt_tail[b]``, else head), so models score
    them against one folded per-row base (``KGEModel.score_one_side``)."""

    pos_h: Tensor
    pos_t: Tensor
    pos_r: Tensor
    neg_ent: Tensor  # [B, K] replacement entity ids
    corrupt_tail: Tensor  # [B] bool: True -> negatives are (h, r, neg_ent)


Batch = Union[TripleBatch, CorruptBatch]


def batch_to(batch: Batch, device) -> Batch:
    """A batch of numpy arrays or tensors as tensors on ``device``: ids
    int64, ``corrupt_tail`` bool."""
    return type(batch)(*(torch.as_tensor(x).to(device, torch.bool if n == "corrupt_tail"
                                                else torch.int64)
                         for n, x in zip(batch._fields, batch)))


class TripleSet:
    """Exact membership of (h, r, t) triples: sorted int64 keys on a device."""

    def __init__(self, h: np.ndarray, r: np.ndarray, t: np.ndarray, rel_tot: int, ent_tot: int,
                 device="cpu"):
        self.rel_tot, self.ent_tot = rel_tot, ent_tot
        keys = (np.asarray(h, np.int64) * rel_tot + np.asarray(r, np.int64)) * ent_tot \
            + np.asarray(t, np.int64)
        self.keys = torch.from_numpy(np.unique(keys)).to(device)

    def contains(self, h: Tensor, r: Tensor, t: Tensor) -> Tensor:
        q = (h.long() * self.rel_tot + r.long()) * self.ent_tot + t.long()
        idx = torch.searchsorted(self.keys, q).clamp_max(self.keys.numel() - 1)
        return self.keys[idx] == q


class DeviceKG(NamedTuple):
    """Train triples, their membership set and the Bernoulli statistics, on
    one device."""

    train_h: Tensor
    train_t: Tensor
    train_r: Tensor
    known: TripleSet
    bern_tail_prob: Tensor  # [R]
    ent_tot: int
    rel_tot: int

    @classmethod
    def from_kgdata(cls, data: KGData, device="cpu") -> "DeviceKG":
        h, t, r = data.train[:, 0], data.train[:, 1], data.train[:, 2]
        as_ids = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int64)).to(device)  # noqa: E731
        return cls(train_h=as_ids(h), train_t=as_ids(t), train_r=as_ids(r),
                   known=TripleSet(h, r, t, data.rel_tot, data.ent_tot, device),
                   bern_tail_prob=torch.from_numpy(data.bern_tail_prob()).to(device),
                   ent_tot=data.ent_tot, rel_tot=data.rel_tot)

    @property
    def device(self) -> torch.device:
        return self.train_h.device


def _pick_positives(generator, kg: DeviceKG, batch_size: int):
    idx = torch.randint(0, len(kg.train_h), (batch_size,), generator=generator, device=kg.device)
    return kg.train_h[idx], kg.train_t[idx], kg.train_r[idx]


def sample_batch(generator: torch.Generator, kg: DeviceKG, batch_size: int, neg_rate: int = 1,
                 bern: bool = False, filtered: bool = True, rejection_rounds: int = 4) -> TripleBatch:
    """One training batch, each negative corrupting its own side."""
    h, t, r = _pick_positives(generator, kg, batch_size)
    shape = (batch_size, neg_rate)
    p_tail = kg.bern_tail_prob[r][:, None] if bern else 0.5
    corrupt_tail = torch.rand(shape, generator=generator, device=kg.device) < p_tail
    rb = r[:, None].expand(shape)

    def propose():
        cand = torch.randint(0, kg.ent_tot, shape, generator=generator, device=kg.device)
        return torch.where(corrupt_tail, h[:, None], cand), torch.where(corrupt_tail, cand, t[:, None])

    nh, nt = propose()
    if filtered:
        bad = kg.known.contains(nh, rb, nt)
        for _ in range(1, rejection_rounds):
            nh2, nt2 = propose()
            nh, nt = torch.where(bad, nh2, nh), torch.where(bad, nt2, nt)
            bad = bad & kg.known.contains(nh, rb, nt)
    return TripleBatch(pos_h=h, pos_t=t, pos_r=r, neg_h=nh, neg_t=nt, neg_r=rb)


def sample_batch_oneside(generator: torch.Generator, kg: DeviceKG, batch_size: int,
                         neg_rate: int = 1, bern: bool = False, filtered: bool = True,
                         rejection_rounds: int = 4) -> CorruptBatch:
    """Like :func:`sample_batch` with ONE corruption side per row, for the
    folded ``score_one_side`` path."""
    h, t, r = _pick_positives(generator, kg, batch_size)
    shape = (batch_size, neg_rate)
    p_tail = kg.bern_tail_prob[r] if bern else 0.5
    corrupt_tail = torch.rand(batch_size, generator=generator, device=kg.device) < p_tail
    ct, rb = corrupt_tail[:, None], r[:, None].expand(shape)

    def known(cand):
        return kg.known.contains(torch.where(ct, h[:, None], cand), rb,
                                 torch.where(ct, cand, t[:, None]))

    def propose():
        return torch.randint(0, kg.ent_tot, shape, generator=generator, device=kg.device)

    cand = propose()
    if filtered:
        bad = known(cand)
        for _ in range(1, rejection_rounds):
            cand = torch.where(bad, propose(), cand)
            bad = bad & known(cand)
    return CorruptBatch(pos_h=h, pos_t=t, pos_r=r, neg_ent=cand, corrupt_tail=corrupt_tail)


class NumpySampler:
    """Host-side sampler with OpenKE-exact filtered corruption (numpy).

    Corrupted entities are drawn uniformly from the exact complement set
    (the "skip known tails" index arithmetic of ``Corrupt.h:corrupt_head/
    tail``, realized with searchsorted over per-(e, r) sorted neighbour
    lists).  Returns batches of numpy arrays (:func:`batch_to` moves them).
    """

    def __init__(self, data: KGData, seed: int = 0):
        self.data = data
        self.rng = np.random.default_rng(seed)
        h, t, r = data.train[:, 0], data.train[:, 1], data.train[:, 2]
        # (h, r) -> sorted tails; (t, r) -> sorted heads.
        order_ht = np.lexsort((t, r, h))
        self._ht_keys = (h * data.rel_tot + r)[order_ht]
        self._ht_tails = t[order_ht]
        order_th = np.lexsort((h, r, t))
        self._th_keys = (t * data.rel_tot + r)[order_th]
        self._th_heads = h[order_th]
        self._bern_p = data.bern_tail_prob()

    def _corrupt(self, keys, values, query_key, count):
        """Uniform draw from [0, ent_tot) minus the sorted ``values`` of ``query_key``."""
        lo = np.searchsorted(keys, query_key, "left")
        hi = np.searchsorted(keys, query_key, "right")
        known = values[lo:hi]  # sorted entity ids to skip
        if len(known) >= self.data.ent_tot:  # degenerate: every entity known
            return self.rng.integers(0, self.data.ent_tot, size=count)
        draws = self.rng.integers(0, self.data.ent_tot - len(known), size=count)
        # Shift each draw past the known entities below it.
        return draws + np.searchsorted(known - np.arange(len(known)), draws, "right")

    def sample(self, batch_size: int, neg_rate: int = 1, bern: bool = False) -> TripleBatch:
        data = self.data
        idx = self.rng.integers(0, data.train_total, size=batch_size)
        h, t, r = data.train[idx, 0], data.train[idx, 1], data.train[idx, 2]
        neg_h = np.repeat(h[:, None], neg_rate, 1).copy()
        neg_t = np.repeat(t[:, None], neg_rate, 1).copy()
        neg_r = np.repeat(r[:, None], neg_rate, 1)
        p_tail = self._bern_p[r] if bern else np.full(batch_size, 0.5, np.float32)
        for i in range(batch_size):
            tails = self.rng.random(neg_rate) < p_tail[i]
            n_tail = int(tails.sum())
            if n_tail:
                neg_t[i, tails] = self._corrupt(
                    self._ht_keys, self._ht_tails, h[i] * data.rel_tot + r[i], n_tail
                )
            if neg_rate - n_tail:
                neg_h[i, ~tails] = self._corrupt(
                    self._th_keys, self._th_heads, t[i] * data.rel_tot + r[i], neg_rate - n_tail
                )
        return TripleBatch(pos_h=h, pos_t=t, pos_r=r, neg_h=neg_h, neg_t=neg_t, neg_r=neg_r)

"""OpenKE benchmark file reader (numpy; a copy of ``skghoi_tpu.kge.data``).

File format (reference ``OpenKE/openke/base/Reader.h:52-160``): each of
``entity2id.txt`` / ``relation2id.txt`` starts with a count line;
``{train,valid,test}2id.txt`` start with a count line followed by
``h t r`` id triples, one per line.  ``type_constrain.txt`` lists, per
relation, the admissible head and tail entity sets.

Like the reference reader, train triples are deduplicated.  The class
precomputes everything the samplers and the tester need as arrays:

- Bernoulli corruption stats: ``left_mean[r]`` = triples(r) / #distinct heads
  of r, ``right_mean[r]`` = triples(r) / #distinct tails of r
  (``Reader.h:142-159``); with ``bern`` the tail is corrupted with probability
  ``right_mean / (left_mean + right_mean)`` (``Base.cpp:112-114``).
- Sorted encoded triple keys (``(h * R + r) * E + t`` as int64) for train-only
  and train+valid+test sets: membership = ``searchsorted`` + equality, the
  in-graph analogue of the reference's binary-search ``_find``
  (``Corrupt.h:166-177``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np


def _read_count_file(path: str) -> int:
    with open(path, "r") as f:
        return int(f.readline().split()[0])


def _read_triples(path: str) -> np.ndarray:
    """Read an ``h t r`` triple file -> int64 ``[N, 3]`` array."""
    with open(path, "r") as f:
        n = int(f.readline().split()[0])
        data = np.loadtxt(f, dtype=np.int64, max_rows=n)
    if data.ndim == 1:
        data = data.reshape(1, 3)
    assert data.shape == (n, 3), f"{path}: expected {n} triples, got {data.shape}"
    return data


@dataclass
class KGData:
    """In-memory knowledge graph with precomputed sampling/eval structures."""

    ent_tot: int
    rel_tot: int
    train: np.ndarray  # [N, 3] (h, t, r), deduplicated
    valid: np.ndarray
    test: np.ndarray
    left_mean: np.ndarray = field(repr=False)  # [R]
    right_mean: np.ndarray = field(repr=False)  # [R]
    train_keys: np.ndarray = field(repr=False)  # sorted encoded train triples
    all_keys: np.ndarray = field(repr=False)  # sorted encoded train+valid+test
    head_type: Optional[Dict[int, np.ndarray]] = None  # r -> admissible heads
    tail_type: Optional[Dict[int, np.ndarray]] = None

    @property
    def train_total(self) -> int:
        return len(self.train)

    def encode(self, h: np.ndarray, t: np.ndarray, r: np.ndarray) -> np.ndarray:
        """Unique int64 key per (h, r, t); row-major in (h, r, t) order."""
        return (h.astype(np.int64) * self.rel_tot + r.astype(np.int64)) * self.ent_tot + t.astype(
            np.int64
        )

    def contains(self, h, t, r, keys: Optional[np.ndarray] = None) -> np.ndarray:
        keys = self.train_keys if keys is None else keys
        q = self.encode(np.asarray(h), np.asarray(t), np.asarray(r))
        idx = np.searchsorted(keys, q)
        idx = np.clip(idx, 0, len(keys) - 1)
        return keys[idx] == q

    @classmethod
    def load(cls, path: str, with_type_constrain: bool = False) -> "KGData":
        ent_tot = _read_count_file(os.path.join(path, "entity2id.txt"))
        rel_tot = _read_count_file(os.path.join(path, "relation2id.txt"))
        train = _read_triples(os.path.join(path, "train2id.txt"))
        valid_path = os.path.join(path, "valid2id.txt")
        test_path = os.path.join(path, "test2id.txt")
        valid = _read_triples(valid_path) if os.path.exists(valid_path) else np.zeros((0, 3), np.int64)
        test = _read_triples(test_path) if os.path.exists(test_path) else np.zeros((0, 3), np.int64)
        return cls.build(ent_tot, rel_tot, train, valid, test,
                         type_path=os.path.join(path, "type_constrain.txt") if with_type_constrain else None)

    @classmethod
    def build(
        cls,
        ent_tot: int,
        rel_tot: int,
        train: np.ndarray,
        valid: Optional[np.ndarray] = None,
        test: Optional[np.ndarray] = None,
        type_path: Optional[str] = None,
    ) -> "KGData":
        valid = np.zeros((0, 3), np.int64) if valid is None else np.asarray(valid, np.int64)
        test = np.zeros((0, 3), np.int64) if test is None else np.asarray(test, np.int64)
        train = np.asarray(train, np.int64)

        # Deduplicate train triples (Reader.h:93-106).
        enc = (train[:, 0] * rel_tot + train[:, 2]) * ent_tot + train[:, 1]
        _, uniq_idx = np.unique(enc, return_index=True)
        train = train[np.sort(uniq_idx)]

        h, t, r = train[:, 0], train[:, 1], train[:, 2]
        counts = np.bincount(r, minlength=rel_tot).astype(np.float64)
        # distinct (h, r) pairs -> heads per relation; distinct (t, r) -> tails.
        hr = np.unique(h * rel_tot + r)
        tr = np.unique(t * rel_tot + r)
        distinct_heads = np.bincount(hr % rel_tot, minlength=rel_tot).astype(np.float64)
        distinct_tails = np.bincount(tr % rel_tot, minlength=rel_tot).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            left_mean = np.where(distinct_heads > 0, counts / distinct_heads, 0.0)
            right_mean = np.where(distinct_tails > 0, counts / distinct_tails, 0.0)

        def keys_of(arr):
            return np.sort((arr[:, 0] * rel_tot + arr[:, 2]) * ent_tot + arr[:, 1])

        train_keys = keys_of(train)
        all_keys = keys_of(np.concatenate([train, valid, test], axis=0))

        head_type = tail_type = None
        if type_path and os.path.exists(type_path):
            head_type, tail_type = _read_type_constrain(type_path)

        return cls(
            ent_tot=ent_tot,
            rel_tot=rel_tot,
            train=train,
            valid=valid,
            test=test,
            left_mean=left_mean.astype(np.float32),
            right_mean=right_mean.astype(np.float32),
            train_keys=train_keys,
            all_keys=all_keys,
            head_type=head_type,
            tail_type=tail_type,
        )

    def bern_tail_prob(self) -> np.ndarray:
        """P(corrupt the tail | relation) under the Bernoulli scheme."""
        denom = self.left_mean + self.right_mean
        return np.where(denom > 0, self.right_mean / np.maximum(denom, 1e-12), 0.5).astype(
            np.float32
        )


def _read_type_constrain(path: str) -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray]]:
    """Parse ``type_constrain.txt``: count line, then for each relation two
    lines ``rel n e1 .. en`` (admissible heads, then admissible tails)."""
    head_type: Dict[int, np.ndarray] = {}
    tail_type: Dict[int, np.ndarray] = {}
    with open(path, "r") as f:
        n_rel = int(f.readline().split()[0])
        for _ in range(n_rel):
            for store in (head_type, tail_type):
                parts = f.readline().split()
                rel, cnt = int(parts[0]), int(parts[1])
                store[rel] = np.asarray(sorted(int(x) for x in parts[2 : 2 + cnt]), np.int64)
    return head_type, tail_type

"""The numbers that decide ``correct``, each held to its limit.

Every number is a gap between what the program produced on the timed path
and what the plain reference computes from the same inputs and weights; a
run is correct when every number is at or under its limit (a NaN is not).
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, Iterable

import torch

Tensor = torch.Tensor


def _finite(gap: float) -> float:
    """A gap that is not a number reads as infinitely wide."""
    return gap if math.isfinite(gap) else math.inf


def worst(gaps) -> float:
    """The largest gap; infinite if any is not a number."""
    return max((_finite(g) for g in gaps), default=0.0)


def relative_gap(got: float, want: float) -> float:
    return _finite(abs(got - want) / max(abs(want), 1e-30))


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], counted: Iterable[str]) -> Dict[str, float]:
    """Each ``counted`` leaf's gap between two norms, ``|a - b| / max(b,
    median b)``; a leaf the program lacks reads 1."""
    counted = list(counted)
    mid = median(want[k] for k in counted)
    return {k: _finite(abs(got.get(k, 0.0) - want[k]) / max(want[k], mid, 1e-30)) for k in counted}


def worst_leaf(got: Dict[str, float], want: Dict[str, float], counted: Iterable[str]):
    """``(gap, leaf)`` of the worst leaf of :func:`leaf_gaps`."""
    return max((g, k) for k, g in leaf_gaps(got, want, counted).items())


def median_leaf(got: Dict[str, float], want: Dict[str, float], counted: Iterable[str]) -> float:
    """The median leaf's gap of :func:`leaf_gaps`."""
    return median(leaf_gaps(got, want, counted).values())


def moving_leaves(grad_norms: Dict[str, float], share: float = 1e-3) -> list:
    """Leaves whose reference gradient is at least ``share`` of the median
    leaf's: the rest (a key's bias under softmax) move by round-off alone."""
    mid = median(grad_norms.values())
    return [k for k, v in grad_norms.items() if v >= share * mid]


def scaled_max_gap(got: Tensor, want: Tensor) -> float:
    """``max |got - want| / max |want|``, in float64."""
    if got.shape != want.shape:
        return math.inf
    got, want = got.double(), want.double()
    return _finite(float((got - want).abs().max() / want.abs().max().clamp_min(1e-30)))


def image_max_gap(got: Tensor, want: Tensor) -> float:
    """``max |got - want|`` over the largest departure of one image's output
    from the batch's mean output (``[B, ...]``), in float64: the gap measured
    against what depends on the image, not on what every image shares."""
    if got.shape != want.shape:
        return math.inf
    got, want = got.double(), want.double()
    spread = (want - want.mean(0, keepdim=True)).abs().max().clamp_min(1e-30)
    return _finite(float((got - want).abs().max() / spread))


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """``{name: {"value", "limit", "ok"}}`` for every limited number; one
    that is missing reads NaN and fails."""
    out = {}
    for name, limit in limits.items():
        value = float(readings.get(name, math.nan))
        out[name] = dict(value=value, limit=limit, ok=bool(value <= limit))
    return out

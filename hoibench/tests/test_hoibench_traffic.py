"""The traffic generator: the same pool for the same seed, counts in the
traffic files' ranges, and the same shapes for every seed."""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

from hoibench.traffic import make_pool, object_verb_mask
from tiny import tiny_cell


def _pool(cell, seed):
    return make_pool(cell["traffic_params"], seed, "cpu")


@pytest.mark.parametrize("name", ["scg_r50.train_b8", "scg_r50.serve_b1", "detr_r50.detect_b8"])
def test_pool_is_deterministic_per_seed(name):
    cell = tiny_cell(name)
    a, b, c = _pool(cell, 2**31 + 7), _pool(cell, 2**31 + 7), _pool(cell, 2**31 + 8)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert not all(np.array_equal(x["images"], z["images"]) for x, z in zip(a, c))


def test_counts_fall_in_the_stated_ranges():
    cell = tiny_cell("scg_r50.train_b8")
    t = cell["traffic_params"]
    for seed in (0, 1, 5_000_000_000):
        for b in _pool(cell, seed):
            n = b["det_valid"].sum(1)
            assert ((n >= t["detections"]["valid"][0]) & (n <= t["detections"]["valid"][1])).all()
            assert b["det_valid"].shape[1] == t["detections"]["pad"]
            humans = ((b["det_labels"] == 49) & b["det_valid"]).sum(1)
            assert (humans >= t["detections"]["humans"]).all()
            s = b["det_scores"][b["det_valid"]]
            assert s.min() >= t["detections"]["score"][0] and s.max() <= t["detections"]["score"][1]
            g = b["gt_valid"].sum(1)
            assert ((g >= t["pairs"]["valid"][0]) & (g <= t["pairs"]["valid"][1])).all()
            h, w = b["images"].shape[1:3]
            boxes = b["det_boxes"][b["det_valid"]]
            assert (boxes[:, 2] < w).all() and (boxes[:, 3] < h).all()
            assert (boxes[:, 2] >= boxes[:, 0]).all() and (boxes[:, 3] >= boxes[:, 1]).all()


def test_every_seed_runs_the_same_work_in_another_order():
    cell = tiny_cell("scg_r50.train_b8")
    cell["traffic_params"]["pool"] = 12
    pools = [_pool(cell, s) for s in (1, 2, 3)]
    orders = [[b["images"].shape[1:3] for b in p] for p in pools]
    assert Counter(orders[0]) == Counter(orders[1]) == Counter(orders[2]) == {(64, 96): 8, (96, 64): 4}
    assert len({tuple(o) for o in orders}) > 1
    for key in ("image_sizes", "det_valid", "gt_valid"):
        sets = [sorted(np.concatenate([b[key].reshape(len(b[key]), -1).sum(1) if b[key].dtype == bool
                                       else b[key].max(1) for b in p]).tolist()) for p in pools]
        assert sets[0] == sets[1] == sets[2], key


def test_object_verb_mask_has_the_interactions_and_a_verb_for_every_object():
    m = object_verb_mask(600, 9)
    assert m.sum() == 600 and (m.sum(1) >= 1).all()
    assert np.array_equal(m, object_verb_mask(600, 9))

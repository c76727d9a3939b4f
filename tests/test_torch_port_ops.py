"""Port box ops, NMS, detection filter and spatial encodings vs the JAX package.

Inputs come from numpy seeds and go through both frameworks on the CPU in
float32.  Boxes, IoU, NMS and the filter are held exactly; the encodings to
atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skghoi_tpu.models import interaction_head as jax_head
from skghoi_tpu.ops import boxes as jax_boxes
from skghoi_tpu.ops.spatial import compute_spatial_ratio_encodings as jax_spatial
from skghoi_torch.models.interaction_head import filter_detections
from skghoi_torch.ops import boxes
from skghoi_torch.ops.spatial import compute_spatial_ratio_encodings

torch.set_num_threads(2)


def random_boxes(rng, shape, size=100.0):
    xy = rng.uniform(0, size, (*shape, 2))
    wh = rng.uniform(1, size / 2, (*shape, 2))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def detections(seed, b=3, m=24, tie=False):
    """Raw detections with heavy overlap, some padding, optional tied scores."""
    rng = np.random.default_rng(seed)
    bx = random_boxes(rng, (b, m), size=60.0)
    bx[:, 1::3] = bx[:, ::3] + rng.uniform(-3, 3, bx[:, ::3].shape).astype(np.float32)
    labels = rng.integers(0, 5, (b, m))
    labels[:, : m // 3] = 2  # humans
    scores = rng.uniform(0.1, 1.0, (b, m)).astype(np.float32)
    if tie:
        scores = np.round(scores * 4) / 4  # few distinct values: many ties
    valid = rng.uniform(size=(b, m)) < 0.8
    return bx, labels, scores, valid


def test_box_iou_and_elementwise_iou_match():
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, (13,)), random_boxes(rng, (7,))
    a[3] = 0.0  # zero-area padding box
    np.testing.assert_array_equal(boxes.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(jax_boxes.box_iou(jnp.asarray(a), jnp.asarray(b))))
    c = random_boxes(rng, (13,))
    np.testing.assert_array_equal(
        boxes.elementwise_box_iou(torch.from_numpy(a), torch.from_numpy(c)).numpy(),
        np.asarray(jax_boxes.elementwise_box_iou(jnp.asarray(a), jnp.asarray(c))))
    np.testing.assert_array_equal(boxes.box_area(torch.from_numpy(a)).numpy(),
                                  np.asarray(jax_boxes.box_area(jnp.asarray(a))))


@pytest.mark.parametrize("seed,tie", [(1, False), (2, True), (3, True)])
def test_nms_and_batched_nms_match(seed, tie):
    bx, labels, scores, valid = detections(seed, tie=tie)
    t = [torch.from_numpy(np.asarray(x)) for x in (bx, labels, scores, valid)]
    for thr in (0.3, 0.5):
        got = boxes.nms_keep(t[0], t[2], t[3], thr).numpy()
        got_c = boxes.batched_nms_keep(t[0], t[2], t[1], t[3], thr).numpy()
        for i in range(bx.shape[0]):
            want = jax_boxes.nms_keep(jnp.asarray(bx[i]), jnp.asarray(scores[i]),
                                      jnp.asarray(valid[i]), thr)
            want_c = jax_boxes.batched_nms_keep(jnp.asarray(bx[i]), jnp.asarray(scores[i]),
                                                jnp.asarray(labels[i]), jnp.asarray(valid[i]), thr)
            np.testing.assert_array_equal(got[i], np.asarray(want))
            np.testing.assert_array_equal(got_c[i], np.asarray(want_c))
        assert not (got & ~valid).any(), "padding was kept"


def test_nms_strict_threshold_and_all_invalid():
    # IoU exactly 0.5 is not suppressed (strict >); an all-invalid row keeps nothing.
    bx = torch.tensor([[[0.0, 0.0, 2.0, 1.0], [1.0, 0.0, 3.0, 1.0], [0.0, 0.0, 1.5, 1.0]]])
    sc = torch.tensor([[0.9, 0.8, 0.7]])
    iou = boxes.box_iou(bx[0], bx[0])
    assert iou[0, 2] == 0.75 and abs(float(iou[0, 1]) - 1 / 3) < 1e-6
    keep = boxes.nms_keep(bx, sc, torch.ones(1, 3, dtype=torch.bool), 0.75)
    assert keep.tolist() == [[True, True, True]]
    keep = boxes.nms_keep(bx, sc, torch.zeros(1, 3, dtype=torch.bool), 0.5)
    assert not keep.any()


def _filter_both(bx, labels, scores, valid, **kw):
    got = filter_detections(torch.from_numpy(bx), torch.from_numpy(labels),
                            torch.from_numpy(scores), torch.from_numpy(valid), **kw)
    want = jax_head.filter_detections(jnp.asarray(bx), jnp.asarray(labels), jnp.asarray(scores),
                                      jnp.asarray(valid), **kw)
    return got, want


@pytest.mark.parametrize("seed,tie,kw", [
    (4, False, dict(human_idx=2)),
    (5, True, dict(human_idx=2)),
    (6, True, dict(human_idx=2, max_human=3, max_object=4)),  # caps bind
    (7, False, dict(human_idx=2, box_score_thresh=0.6)),
])
def test_filter_detections_matches(seed, tie, kw):
    bx, labels, scores, valid = detections(seed, tie=tie)
    got, want = _filter_both(bx, labels, scores, valid, **kw)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got.boxes.is_contiguous()  # the RoIAlign kernel takes them as they are


def test_filter_detections_all_invalid():
    bx, labels, scores, valid = detections(8)
    valid[1] = False  # one image with no valid detection
    scores[2] = 0.05  # one image whose detections all miss the threshold
    got, want = _filter_both(bx, labels, scores, valid, human_idx=2)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got.n[1] == 0 and got.n[2] == 0
    assert not got.boxes[1:].any()


def test_spatial_encodings_match():
    rng = np.random.default_rng(9)
    b1 = random_boxes(rng, (2, 15, 1), size=300.0)
    b2 = random_boxes(rng, (2, 1, 30), size=300.0)
    b1[0, 4:] = 0.0  # padded slots
    b2[1, :, 20:] = 0.0
    hs = np.array([480.0, 400.0], np.float32)[:, None, None]
    ws = np.array([640.0, 500.0], np.float32)[:, None, None]
    got = compute_spatial_ratio_encodings(torch.from_numpy(b1), torch.from_numpy(b2),
                                          torch.from_numpy(hs), torch.from_numpy(ws))
    want = jax.jit(jax_spatial)(jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(hs), jnp.asarray(ws))
    assert got.shape == (2, 15, 30, 46) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

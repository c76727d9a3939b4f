"""The port's Faster R-CNN held against the JAX package's, on the CPU.

Both packages load the same seeded torchvision-layout ``state_dict``
(``skghoi_torch.detect.frcnn.random_state_dict``, and the JAX suite's own
``tests/test_frcnn.py::synth_state_dict``) with their own
``load_torch_fasterrcnn``:

- both key layouts load, and the JAX tree mapped by
  ``weights.to_state_dict`` equals the port's import bit for bit;
  a JAX ``FasterRCNN().init`` tree loads into the port strictly;
- anchors equal exactly; ``decode_boxes`` within 1e-6 (the clip before
  ``exp`` reached);
- ``RPNHead``, ``TwoMLPHead`` and ``FastRCNNPredictor`` within 1e-5 of each
  output's largest;
- the whole detector at a 128x192 canvas with the default top-n (1 000 a
  level, 1 000 proposals, a 2 000-candidate pool, 100 detections) and the
  score threshold at 0: proposals and final boxes within 1e-4 (rtol and
  atol), labels and valid masks equal.  Weight seed 0 with image seed 102
  has no near-tie: no two proposals swap places, and the smallest gap
  between consecutive final scores is larger than the largest score
  difference between the packages (asserted).  At image seeds 100 and 101
  two proposals whose objectness probabilities differ by less than the
  packages' rounding swap places, and at 101 that moves one final box.

Also ``chip_smoke.selection_flips``, the check that excuses a differing
NMS or top-k decision between the card and the CPU only as a tie: it
excuses an order swap, a suppression at the IoU threshold and a final cut,
and refuses a suppression above the threshold, a moved box (pool or
selection) and a selected box carrying another entry's score.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skghoi_tpu.detect import frcnn as J
from skghoi_tpu.ops.boxes import batched_nms_keep as j_batched_nms_keep
from skghoi_torch.detect import frcnn as P
from skghoi_torch.weights import to_state_dict
from test_frcnn import synth_state_dict

torch.set_num_threads(2)

CANVAS = (128, 192)
SIZES = np.array([[120.0, 182.0]], np.float32)
WEIGHT_SEED, IMAGE_SEED = 0, 102


def _port(sd, **kw):
    model = P.FasterRCNN(device="cpu", **kw)
    model.load_state_dict(P.load_torch_fasterrcnn(sd), strict=True)
    return model


@pytest.mark.parametrize("new_style", [True, False], ids=["after_0.13", "before_0.13"])
@pytest.mark.parametrize("source", ["jax_suite", "port"])
def test_state_dict_loads_like_jax(new_style, source):
    sd = (synth_state_dict(np.random.default_rng(0), new_style=new_style) if source == "jax_suite"
          else P.random_state_dict(1, new_style=new_style))
    got = P.load_torch_fasterrcnn(sd)
    want = to_state_dict(jax.tree_util.tree_map(np.asarray, J.load_torch_fasterrcnn(sd)))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _port(sd)  # loads strictly


def test_jax_init_tree_loads_into_port():
    model = J.FasterRCNN(pre_nms_top_n=50, post_nms_top_n=20, score_topk=64)
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = jax.jit(lambda r: model.init(r, img, jnp.asarray([[64.0, 64.0]])))(
        jax.random.PRNGKey(0))
    sd = to_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    P.FasterRCNN(device="cpu").load_state_dict(sd, strict=True)


@pytest.mark.parametrize("canvas", [(64, 96), (128, 192), (832, 1344), (1344, 832)])
def test_anchors_equal_jax(canvas):
    for stride, size in zip(P.RPN_STRIDES, P.ANCHOR_SIZES):
        np.testing.assert_array_equal(P.anchors_for_level(canvas, stride, size),
                                      J.anchors_for_level(canvas, stride, size))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), P.BOX_CODER_WEIGHTS])
def test_decode_boxes_equal_jax(weights):
    rng = np.random.default_rng(2)
    anchors = rng.uniform(0, 100, (64, 4)).astype(np.float32)
    anchors[:, 2:] = anchors[:, :2] + rng.uniform(4, 60, (64, 2))
    deltas = (rng.standard_normal((64, 4)) * 2.0).astype(np.float32)
    deltas[:8, 2:] = 30.0  # past BBOX_XFORM_CLIP even at weight 5
    got = P.decode_boxes(torch.from_numpy(anchors), torch.from_numpy(deltas), weights).numpy()
    want = np.asarray(J.decode_boxes(jnp.asarray(anchors), jnp.asarray(deltas), weights))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _rel_close(got, want, tol, name):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    scale = np.abs(np.asarray(want)).max()
    assert scale > 0 and err <= tol * scale, (name, err, scale)


def test_heads_equal_jax():
    sd = P.random_state_dict(WEIGHT_SEED)
    jv = J.load_torch_fasterrcnn(sd)["params"]
    port = _port(sd)
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((1, 10, 12, 256)).astype(np.float32)
    want = J.RPNHead().apply({"params": jv["rpn_head"]}, jnp.asarray(feat))
    with torch.no_grad():
        got = port.rpn_head(torch.from_numpy(feat))
    for g, w, name in zip(got, want, ("rpn logits", "rpn deltas")):
        assert g.shape == w.shape, name
        _rel_close(g.numpy(), w, 1e-5, name)

    pooled = rng.standard_normal((5, 7, 7, 256)).astype(np.float32)
    jx = J.TwoMLPHead().apply({"params": jv["box_head"]}, jnp.asarray(pooled))
    want = J.FastRCNNPredictor().apply({"params": jv["box_predictor"]}, jx)
    with torch.no_grad():
        x = port.box_head(torch.from_numpy(pooled))
        got = port.box_predictor(x)
    _rel_close(x.numpy(), jx, 1e-5, "box_head")
    for g, w, name in zip(got, want, ("class scores", "box deltas")):
        assert g.shape == w.shape, name
        _rel_close(g.numpy(), w, 1e-5, name)


def _jax_proposals(model, variables, images, sizes):
    """The RPN half of ``skghoi_tpu.detect.frcnn.FasterRCNN.__call__``
    (``frcnn.py:151-181``), built from the JAX package's own modules and
    functions: the proposals that feed its RoI heads."""
    feats = model.apply(variables, images, method=lambda m, x: m.fpn(m.body(x)))
    p6 = nn.max_pool(feats[-1], (1, 1), strides=(2, 2))
    b, h, w = images.shape[:3]
    boxes, scores, lvls = [], [], []
    for lvl, (f, s, size) in enumerate(zip((*feats, p6), P.RPN_STRIDES, P.ANCHOR_SIZES)):
        logits, deltas = model.apply(variables, f, method=lambda m, x: m.rpn_head(x))
        anchors = jnp.asarray(J.anchors_for_level((h, w), s, size))
        k = min(model.pre_nms_top_n, logits.shape[1])
        top, idx = jax.lax.top_k(logits, k)
        boxes.append(J.decode_boxes(jnp.take(anchors, idx, axis=0),
                                    jnp.take_along_axis(deltas, idx[..., None], axis=1)))
        scores.append(top)
        lvls.append(jnp.full((b, k), lvl, jnp.int32))
    boxes = J.clip_boxes(jnp.concatenate(boxes, 1), sizes[:, None, :])
    scores = jax.nn.sigmoid(jnp.concatenate(scores, 1))
    ok = ((boxes[..., 2] - boxes[..., 0]) >= 1e-3) & ((boxes[..., 3] - boxes[..., 1]) >= 1e-3)
    keep = jax.vmap(lambda bx, sc, lv, v: j_batched_nms_keep(bx, sc, lv, v, model.rpn_nms_thresh))(
        boxes, scores, jnp.concatenate(lvls, 1), ok)
    top, idx = jax.lax.top_k(jnp.where(keep, scores, -jnp.inf), model.post_nms_top_n)
    return jnp.take_along_axis(boxes, idx[..., None], axis=1), top


@pytest.fixture(scope="module")
def pipelines():
    sd = P.random_state_dict(WEIGHT_SEED)
    images = np.random.default_rng(IMAGE_SEED).standard_normal((1, *CANVAS, 3)).astype(np.float32)
    jm = J.FasterRCNN(box_score_thresh=0.0)
    jv = J.load_torch_fasterrcnn(sd)
    jdet = jax.jit(lambda v, i, s: jm.apply(v, i, s))(jv, images, SIZES)
    jprops = jax.jit(lambda v, i, s: _jax_proposals(jm, v, i, s))(jv, images, SIZES)
    port = _port(sd, box_score_thresh=0.0)
    with torch.no_grad():
        t_img, t_sizes = torch.from_numpy(images), torch.from_numpy(SIZES)
        feats = port.features(t_img)
        props = port.propose(feats, CANVAS, t_sizes)
        det = port.select(port.classify(feats, props, t_sizes))
        assert all(torch.equal(a, b) for a, b in zip(det, port(t_img, t_sizes)))
    return (jax.tree_util.tree_map(np.asarray, jdet), [np.asarray(x) for x in jprops],
            det, props)


def test_proposals_equal_jax(pipelines):
    _, (jboxes, jscores), _, props = pipelines
    assert props.boxes.shape == (1, 1000, 4) and props.candidates == 1000 + 1000 + 288 + 72 + 18
    np.testing.assert_array_equal(props.valid.numpy(), np.isfinite(jscores))
    assert np.isfinite(jscores).sum() > 100
    np.testing.assert_allclose(props.boxes.numpy(), jboxes, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(props.scores.numpy(), jscores, rtol=1e-4, atol=1e-6)


def test_detections_equal_jax(pipelines):
    jdet, _, det, _ = pipelines
    np.testing.assert_array_equal(det.valid.numpy(), jdet.valid)
    assert jdet.valid.sum() == 100
    np.testing.assert_array_equal(det.labels.numpy(), jdet.labels)
    np.testing.assert_allclose(det.boxes.numpy(), jdet.boxes, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(det.scores.numpy(), jdet.scores, rtol=1e-4, atol=1e-7)
    b = det.boxes[det.valid].numpy()
    assert (b[:, :2] >= 0).all() and (b[:, 2] <= SIZES[0, 1]).all()
    assert (b[:, 3] <= SIZES[0, 0]).all()
    # No near-tie at this seed: every consecutive gap between the final
    # scores is wider than the largest score difference between the packages.
    scores = det.scores[0].numpy()
    assert np.min(-np.diff(scores)) > np.abs(scores - jdet.scores[0]).max()


# --- chip_smoke.py's card-against-CPU flip check -----------------------------------
#
# Phase 12 of ``chip_smoke.py`` runs the detector on the card and on the CPU and
# excuses a differing NMS or top-k decision only as a tie.  Here the check
# itself: it must excuse real ties and refuse a device error.

def _entries(*rows):
    """``(boxes, scores, labels)`` from ``(x1, y1, x2, y2, score, label)`` rows."""
    a = np.asarray(rows, np.float64).reshape(-1, 6)
    return a[:, :4], a[:, 4], a[:, 5].astype(np.int64)


_A, _B = (0, 0, 10, 10, 0.5, 1), (1, 0, 11, 10, 0.5 * (1 + 1e-6), 1)  # IoU 0.82
_C = (0, 3.2, 10, 13.2, 0.3, 1)  # IoU 0.515 with A: over 0.5, not within 1e-3 of it
_D = (0, 3.33, 10, 13.33, 0.3, 1)  # IoU 0.5004 with A: a suppression decided at 0.5
_X, _Y = (50, 50, 60, 60, 0.2 * (1 + 1e-6), 2), (80, 80, 90, 90, 0.2, 3)
_FLIP_CASES = {
    # name: (card pool, card selection, CPU pool, CPU selection, a tie?)
    "equal": ((_A, _C, _X), (_A, _X), (_A, _C, _X), (_A, _X), True),
    "order_swap": ((_A, _B, _X), (_A, _X), (_A, _B, _X), (_B, _X), True),
    "iou_at_threshold": ((_A, _D, _X), (_A, _D, _X), (_A, _D, _X), (_A, _X), True),
    "final_cut": ((_A, _X, _Y), (_A, _X), (_A, _X, _Y), (_A, _Y), True),
    "suppressed_above_threshold": ((_A, _C, _X), (_A, _C, _X), (_A, _C, _X), (_A, _X), False),
    "box_moved": (tuple((x1 + 0.5, y1, x2 + 0.5, y2, s, l) for x1, y1, x2, y2, s, l in (_A, _C, _X)),
                  ((0.5, 0, 10.5, 10, 0.5, 1), (50.5, 50, 60.5, 60, _X[4], 2)),
                  (_A, _C, _X), (_A, _X), False),
    "selection_moved": ((_A, _C, _X), ((0.5, 0, 10.5, 10, 0.5, 1), _X), (_A, _C, _X), (_A, _X),
                        False),
    "score_of_another_entry": ((_A, _C, _X), ((0, 0, 10, 10, 0.3, 1), _X), (_A, _C, _X),
                               ((0, 0, 10, 10, 0.5, 1), _X), False),
}


@pytest.mark.parametrize("case", list(_FLIP_CASES))
def test_smoke_flip_check_excuses_only_ties(case):
    import chip_smoke

    pool, sel, cpool, csel, tie = _FLIP_CASES[case]
    flips, _, bad = chip_smoke.selection_flips(_entries(*sel), _entries(*csel), 0.5,
                                               (_entries(*pool), _entries(*cpool)), False)
    assert (not bad) == tie, (flips, bad)
    assert (flips == 0) == (case in ("equal", "score_of_another_entry"))


def test_smoke_flip_check_on_two_detector_runs():
    """Two CPU runs of the detector: no flip; the card side moved by 0.5 px
    is refused at both stages."""
    import chip_smoke

    port = _port(P.random_state_dict(WEIGHT_SEED), box_score_thresh=0.0)
    images = torch.from_numpy(
        np.random.default_rng(IMAGE_SEED).standard_normal((1, *CANVAS, 3)).astype(np.float32))
    sizes = torch.from_numpy(SIZES)
    with torch.no_grad():
        feats = port.features(images)
        pool = port.rpn_candidates(feats, CANVAS, sizes)
        props = port.propose(feats, CANVAS, sizes)
        cand = port.classify(feats, props, sizes)
        det = port.select(cand)
    stages = [(chip_smoke._valid(props.boxes, props.scores, props.levels, props.valid), 0.7,
               chip_smoke._all(pool.boxes, pool.scores, pool.labels), True),
              (chip_smoke._valid(det.boxes, det.scores, det.labels, det.valid), 0.5,
               chip_smoke._valid(*cand), False)]
    for sel, thresh, pl, by_label in stages:
        assert len(sel[1]) > 50
        assert chip_smoke.selection_flips(sel, sel, thresh, (pl, pl), by_label) == (0, 0, [])
        moved = chip_smoke._moved
        assert chip_smoke.selection_flips(moved(sel), sel, thresh, (moved(pl), pl), by_label)[2]
        assert chip_smoke.selection_flips(moved(sel), sel, thresh, (pl, pl), by_label)[2]

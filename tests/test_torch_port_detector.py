"""The port's FPN detector held against the JAX package's, on the CPU.

One JAX ``FPNDetector().init`` at 64x96 (full widths: 80 classes, 256
channels, 9 anchors a cell on P3-P5) is loaded into the port through
``weights.to_state_dict``:

- anchors equal exactly; the delta round trip within rtol 1e-4 / atol 1e-3
  (``tests/test_detector.py``), and both codings within 1e-5 of JAX's;
- ``match_anchors`` states and targets equal JAX's;
- the forward: logits and deltas within 1e-4 of each output's largest
  (the order of anchors included: a head flattened in NCHW would put every
  logit on the wrong anchor with all shapes agreeing);
- ``detector_loss`` at rtol 1e-5, and every gradient within 1e-3 of its
  tensor's largest (``tests/test_torch_port_train.py``'s bound);
- ``decode_detections`` on the same outputs: boxes within 1e-4, labels and
  valid masks equal (weight key 0, image seed 0: no near-tie among the
  kept scores; the smallest gap is asserted);
- the port of ``test_detector_overfits_one_box``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skghoi_tpu.detect import detector as J
from skghoi_torch.detect import detector as P
from skghoi_torch.weights import to_state_dict

torch.set_num_threads(2)

CANVAS = (64, 96)


def _rel_close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert got.shape == want.shape and scale > 0 and err <= tol * scale, (name, err, scale)


def _gt():
    boxes = np.array([[[10.0, 8.0, 40.0, 50.0], [50.0, 10.0, 90.0, 40.0], [0.0, 0.0, 0.0, 0.0]],
                      [[20.0, 16.0, 60.0, 48.0], [5.0, 30.0, 30.0, 62.0], [20.0, 16.0, 60.0, 48.0]]],
                     np.float32)
    labels = np.array([[49, 7, 0], [3, 49, 3]], np.int32)
    valid = np.array([[True, True, False], [True, True, True]])
    return boxes, labels, valid


@pytest.fixture(scope="module")
def setup():
    images = np.random.default_rng(0).uniform(0, 1, (2, *CANVAS, 3)).astype(np.float32)
    model = J.FPNDetector()
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(images)))
    port = P.FPNDetector(device="cpu")
    port.load_state_dict(to_state_dict(variables), strict=True)
    return images, model, variables, port


@pytest.mark.parametrize("canvas", [(64, 96), (96, 64), (832, 1344)])
def test_anchors_equal_jax(canvas):
    np.testing.assert_array_equal(P.generate_anchors(canvas), J.generate_anchors(canvas))


def test_delta_roundtrip_and_codings():
    rng = np.random.default_rng(0)
    anchors = P.generate_anchors(CANVAS)[:50]
    xy = rng.uniform(0, 60, (50, 2))
    wh = rng.uniform(4, 30, (50, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    a, b = torch.from_numpy(anchors), torch.from_numpy(boxes)
    enc = P.encode_deltas(a, b)
    np.testing.assert_allclose(P.decode_deltas(a, enc).numpy(), boxes, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(enc.numpy(), J.encode_deltas(anchors, boxes), rtol=1e-5, atol=1e-5)
    deltas = (rng.standard_normal((50, 4)) * 3).astype(np.float32)  # past the +-4 clip
    np.testing.assert_allclose(P.decode_deltas(a, torch.from_numpy(deltas)).numpy(),
                               J.decode_deltas(anchors, deltas), rtol=1e-5, atol=1e-4)


def test_match_anchors_equal_jax():
    anchors = np.array([[0, 0, 16, 16], [0, 0, 15, 17], [40, 40, 56, 56], [7, 7, 24, 24.0]],
                       np.float32)
    cls_t, box_t, state = P.match_anchors(torch.from_numpy(anchors),
                                          torch.tensor([[[0, 0, 16, 16.0]]]),
                                          torch.tensor([[5]]), torch.ones(1, 1, dtype=torch.bool))
    assert state[0].tolist()[0] == 1 and state[0].tolist()[2] == 0
    assert cls_t[0, 0, 5] == 1.0 and cls_t[0, 2].sum() == 0
    full = P.generate_anchors(CANVAS)
    boxes, labels, valid = _gt()
    got = P.match_anchors(torch.from_numpy(full), torch.from_numpy(boxes),
                          torch.from_numpy(labels).long(), torch.from_numpy(valid))
    want = jax.vmap(lambda b, l, v: J.match_anchors(jnp.asarray(full), b, l, v))(
        boxes, labels, valid)
    assert (np.asarray(want[2]) == 1).sum() > 5, "no positive anchor: the test would be vacuous"
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)


def test_forward_equals_jax(setup):
    images, model, variables, port = setup
    want = model.apply(variables, jnp.asarray(images))
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    assert got[0].shape == (2, len(P.generate_anchors(CANVAS)), 80)
    for g, w, name in zip(got, want, ("logits", "deltas")):
        _rel_close(g.numpy(), w, 1e-4, name)


def test_loss_and_gradients_equal_jax(setup):
    images, model, variables, port = setup
    anchors = P.generate_anchors(CANVAS)
    boxes, labels, valid = _gt()
    extra = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
        logits, deltas = model.apply({"params": p, **extra}, jnp.asarray(images))
        losses = J.detector_loss(logits, deltas, jnp.asarray(anchors), boxes, labels, valid)
        return losses["cls_loss"] + losses["box_loss"], losses

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    want_grads = to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})

    port.zero_grad()
    logits, deltas = port(torch.from_numpy(images))
    got = P.detector_loss(logits, deltas, torch.from_numpy(anchors), torch.from_numpy(boxes),
                          torch.from_numpy(labels).long(), torch.from_numpy(valid))
    (got["cls_loss"] + got["box_loss"]).backward()
    for k in ("cls_loss", "box_loss"):
        assert float(want[k]) > 0
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
    named = dict(port.named_parameters())  # frozen-BN terms are buffers, with no gradient
    assert len(named) > 80 and named.keys() <= want_grads.keys()
    for name, p in named.items():
        g = want_grads[name]
        scale = g.abs().max().item()
        got_g = torch.zeros_like(p) if p.grad is None else p.grad  # P2's output conv: unused
        err = (got_g - g).abs().max().item()
        assert err <= 1e-3 * max(scale, 1e-12), (name, err, scale)


def test_decode_detections_equal_jax(setup):
    images, model, variables, port = setup
    anchors = P.generate_anchors(CANVAS)
    logits, deltas = (np.asarray(x) for x in model.apply(variables, jnp.asarray(images)))
    want = J.decode_detections(jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(anchors),
                               CANVAS, score_thresh=0.0, pre_nms_topk=300)
    got = P.decode_detections(torch.from_numpy(logits), torch.from_numpy(deltas),
                              torch.from_numpy(anchors), CANVAS, score_thresh=0.0,
                              pre_nms_topk=300)
    kept = np.asarray(want.scores)[np.asarray(want.valid)]
    assert kept.size > 20
    gaps = np.diff(np.sort(np.asarray(want.scores), axis=1), axis=1)
    assert gaps[gaps > 0].min() > 1e-7, "a near-tie of scores: name the seed"
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5)


def test_detector_overfits_one_box():
    """A few hundred steps on one image must localize the single GT box
    (``tests/test_detector.py::test_detector_overfits_one_box``)."""
    model = P.FPNDetector(device="cpu")
    images = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, *CANVAS, 3))
                              .astype(np.float32))
    gt_boxes = torch.tensor([[[20.0, 16.0, 60.0, 48.0]]])
    gt_labels, gt_valid = torch.tensor([[7]]), torch.ones(1, 1, dtype=torch.bool)
    anchors = torch.from_numpy(P.generate_anchors(CANVAS))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    first = None
    for _ in range(150):
        opt.zero_grad()
        losses = P.detector_loss(*model(images), anchors, gt_boxes, gt_labels, gt_valid)
        total = losses["cls_loss"] + losses["box_loss"]
        total.backward()
        opt.step()
        first = total.item() if first is None else first
    assert total.item() < first * 0.2, (first, total.item())
    with torch.no_grad():
        det = P.decode_detections(*model(images), anchors, CANVAS, score_thresh=0.2, max_out=5)
    top = det.boxes[0, 0].numpy()
    gt = gt_boxes[0, 0].numpy()
    ix = max(0, min(top[2], gt[2]) - max(top[0], gt[0]))
    iy = max(0, min(top[3], gt[3]) - max(top[1], gt[1]))
    union = (top[2] - top[0]) * (top[3] - top[1]) + (gt[2] - gt[0]) * (gt[3] - gt[1]) - ix * iy
    assert ix * iy / union > 0.5, (top, gt)
    assert int(det.labels[0, 0]) == 7

"""The port's AdaMixer against the benchmark's plain reference
(``hoibench/reference/adamixer.py``: its own sampling by ``grid_sample``,
mixing by ``einsum``, set loss and Hungarian) on the CPU, at 64x96, batch 2,
10 queries, 2 stages, content 64 (so the per-level maps to the content width
run), 8 points in and 16 out, FFN 128, with the seeded weights of
``hoibench.weights`` from the reference's init kinds loaded into both:

- every stage's class logits and boxes within 1e-5 of the largest, with the
  stem and ``layer1`` trained and frozen (``frozen_stages`` -1 and 1);
- the reference's Hungarian against scipy's, and the two packages'
  assignments equal; the set loss on shared assignments at rtol 1e-6;
- every gradient of the set loss within 1e-4 of its tensor's largest (the
  attention's key bias, whose gradient is 0, at its weight's) in float32
  (measured 3.3e-6), and within 1e-9 in float64, where a sampling point near
  a cell edge (bilinear sampling's derivative jumps there) cannot part them;
  the frozen tensors get none;
- AdamW steps of ``train_detector`` (weight decay 0.5) leave every frozen
  parameter bit for bit, which the optimizer over every parameter with a
  zero gradient for those without one (the tool before ``--frozen-stages``)
  does not.
"""

import copy

import numpy as np
import pytest
import torch

from hoibench.reference import adamixer as ref
from hoibench.weights import make_state
from skghoi_torch.detect import adamixer
from skghoi_torch.detect.adamixer import AdaMixerDetector
from skghoi_torch.tools.train_detector import _first_occurrence_mask, adamw, build_adamixer_step

torch.set_num_threads(2)

CANVAS = (64, 96)
CFG = dict(num_classes=80, num_queries=10, num_stages=2, content_dim=64, groups=4, in_points=8,
           out_points=16, ffn_dim=128)
SEED = 2


def _models(frozen_stages: int):
    """The reference and the port with the same seeded weights, float32."""
    cfg = dict(CFG, frozen_stages=frozen_stages, num_heads=8, tau=2.0)
    reference = ref.AdaMixer(cfg)
    meta = ref.AdaMixer(cfg).to("meta")
    state = make_state(meta, meta.init_kinds(), SEED, "cpu")
    reference.load_state_dict(state)
    port = AdaMixerDetector(device="cpu", frozen_stages=frozen_stages, **CFG)
    port.load_state_dict(state)
    return reference, port


def _batch():
    """Images in [0, 1] and the HOI pairs' boxes (``hoibench.reference``'s
    batch keys), two images with 6 and 3 pairs of 8 slots."""
    g = torch.Generator().manual_seed(7)
    images = torch.rand((2, *CANVAS, 3), generator=g)
    xy = torch.rand((2, 8, 2), generator=g) * torch.tensor([60.0, 40.0])
    wh = 8 + torch.rand((2, 8, 2), generator=g) * 30

    def boxes():
        return torch.cat([xy, (xy + wh).minimum(torch.tensor([95.0, 63.0]))], -1)

    valid = torch.zeros((2, 8), dtype=torch.bool)
    valid[0, :6], valid[1, :3] = True, True
    return dict(images=images, gt_boxes_h=boxes(), gt_boxes_o=boxes().flip(1),
                gt_object=torch.randint(0, 80, (2, 8), generator=g), gt_valid=valid)


def _port_gt(batch):
    """``train_detector``'s ground truth and de-duplication of the batch."""
    boxes = torch.cat([batch["gt_boxes_h"], batch["gt_boxes_o"]], 1)
    labels = torch.cat([torch.full_like(batch["gt_object"], 49), batch["gt_object"]], 1)
    valid = torch.cat([batch["gt_valid"], batch["gt_valid"]], 1)
    return boxes, labels, torch.from_numpy(_first_occurrence_mask(boxes.numpy(), labels.numpy(),
                                                                  valid.numpy()))


def _float64(model):
    model = copy.deepcopy(model).double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return model


@pytest.mark.parametrize("frozen_stages", [-1, 1])
def test_every_stage_matches_the_reference(frozen_stages):
    reference, port = _models(frozen_stages)
    images = _batch()["images"]
    with torch.no_grad():
        logits, boxes = reference(images)
        out = port(images)
    assert logits.shape == out.cls_logits.shape == (2, 2, 10, 80)
    for s in range(2):
        for got, want in ((out.cls_logits[s], logits[s]), (out.boxes[s], boxes[s])):
            assert (got - want).abs().max() <= 1e-5 * want.abs().max(), s
    # The boxes move between the stages and the queries differ.
    assert (boxes[1] - boxes[0]).abs().max() > 1.0 and boxes[1].std(1).min() > 0.1


def test_the_reference_hungarian_is_scipys():
    from scipy.optimize import linear_sum_assignment

    rng = np.random.default_rng(0)
    for n, m in [(1, 10), (5, 10), (10, 10), (24, 100), (3, 7)]:
        cost = rng.standard_normal((n, m))
        rows, cols = linear_sum_assignment(cost)
        got = ref.hungarian(cost)
        assert len(set(got.tolist())) == n
        assert cost[np.arange(n), got].sum() == pytest.approx(cost[rows, cols].sum(), abs=1e-12)
    # More ground truth than queries: the extra ground truth stays unmatched.
    cost = torch.from_numpy(rng.standard_normal((1, 1, 3, 5)))
    got = ref.assignments(cost, torch.ones((1, 5), dtype=torch.bool))
    rows, cols = linear_sum_assignment(cost[0, 0].numpy())
    assert sorted(got[0, 0][got[0, 0] >= 0].tolist()) == [0, 1, 2]
    assert cost[0, 0].numpy()[got[0, 0][cols], cols].sum() == pytest.approx(
        cost[0, 0].numpy()[rows, cols].sum())


def _losses(reference, port, batch, assign):
    gt = ref.ground_truth(batch)
    logits, boxes = reference(batch["images"])
    want = ref.set_loss(logits, boxes, assign, *gt, CANVAS)
    got = adamixer.set_loss(port(batch["images"]), torch.from_numpy(assign), *_port_gt(batch),
                            CANVAS)["set_loss"]
    return got, want


def test_assignments_and_set_loss_match():
    reference, port = _models(1)
    batch = _batch()
    gt = ref.ground_truth(batch)
    assert torch.equal(gt[2], _port_gt(batch)[2]) and int(gt[2].sum()) == 18
    with torch.no_grad():
        logits, boxes = reference(batch["images"])
        want = ref.assignments(ref.match_cost(logits, boxes, *gt[:2], CANVAS), gt[2])
        got = adamixer.compute_assignments(port(batch["images"]), *_port_gt(batch), CANVAS)
        np.testing.assert_array_equal(got, want)
        loss, ref_loss = _losses(reference, port, batch, want)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)


def _grads(model, loss):
    model.zero_grad(set_to_none=True)
    loss.backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("frozen_stages", [-1, 1])
def test_every_gradient_matches_the_reference(frozen_stages):
    reference, port = _models(frozen_stages)
    batch = _batch()
    gt = ref.ground_truth(batch)
    with torch.no_grad():
        logits, boxes = reference(batch["images"])
        assign = ref.assignments(ref.match_cost(logits, boxes, *gt[:2], CANVAS), gt[2])
    loss, ref_loss = _losses(reference, port, batch, assign)
    got, want = _grads(port, loss), _grads(reference, ref_loss)
    frozen = {n for n, p in reference.named_parameters() if not p.requires_grad}
    assert got.keys() == want.keys() == {n for n, _ in port.named_parameters()} - frozen
    assert bool(frozen) == (frozen_stages == 1)

    def scale(grads, n):
        # The attention's key bias has an exact gradient of 0 (it shifts a
        # softmax row alike): held at the key weight's scale.
        return grads[n.replace("key.bias", "key.weight")].abs().max()

    for n in want:
        assert (got[n] - want[n]).abs().max() <= 1e-4 * scale(want, n), n
    # In float64 too: a sampling point near a cell edge, where bilinear
    # sampling's derivative jumps, would part the float32 gradients alone.
    port64, ref64 = _float64(port), _float64(reference)
    batch64 = dict(batch, images=batch["images"].double(), gt_boxes_h=batch["gt_boxes_h"].double(),
                   gt_boxes_o=batch["gt_boxes_o"].double())
    loss64, ref_loss64 = _losses(ref64, port64, batch64, assign)
    got64, want64 = _grads(port64, loss64), _grads(ref64, ref_loss64)
    for n in want64:
        assert (got64[n] - want64[n]).abs().max() <= 1e-9 * scale(want64, n), n


def test_adamw_leaves_every_frozen_parameter_bit_for_bit():
    """Two steps of the AdaMixer step at weight decay 0.5: the frozen stem and
    ``layer1`` stay bit for bit and every trainable leaf moves.  The same
    steps with the tool's update before ``--frozen-stages`` (AdamW over every
    parameter, a zero gradient for each without one) shrink them."""
    from skghoi_torch.parallel.mesh import all_reduce_mean_
    from skghoi_torch.tools import train_detector

    def every_parameter(model, optimizer, losses):
        sum(losses.values()).backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in model.parameters()]
        for p, g in zip(model.parameters(), grads):
            p.grad = g
        out = {k: v.detach() for k, v in losses.items()}
        all_reduce_mean_([*grads, *out.values()])
        optimizer.step()
        return out

    batch = _batch()
    gt = _port_gt(batch)
    moved = {}
    for name, apply, optimizer in [
            ("port", train_detector._apply, adamw),
            ("every parameter", every_parameter,
             lambda m, lr, wd: torch.optim.AdamW(m.parameters(), lr=lr, weight_decay=wd))]:
        _, port = _models(1)
        start = {n: p.detach().clone() for n, p in port.named_parameters()}
        frozen = [n for n, p in port.named_parameters() if not p.requires_grad]
        assert any(n.startswith("backbone.backbone.layer1.") for n in frozen)
        assert any(n.startswith("backbone.backbone.conv1.") for n in frozen)
        step = build_adamixer_step(port, optimizer(port, 1e-2, 0.5))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(train_detector, "_apply", apply)
            for _ in range(2):
                step(batch["images"], *gt)
        now = dict(port.named_parameters())
        moved[name] = [n for n in frozen if not torch.equal(now[n], start[n])]
        assert all(not torch.equal(now[n], start[n]) for n in now if n not in frozen)
    assert moved["port"] == []
    assert len(moved["every parameter"]) == len(frozen)

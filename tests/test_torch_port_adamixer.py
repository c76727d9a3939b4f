"""The port's AdaMixer held against the JAX package's, on the CPU.

- box parameterisation, position embedding: within 1e-5 of JAX's;
- ``sample_3d`` against JAX and the torch oracle
  (``skghoi_tpu.oracle.adamixer.sample_3d_torch``) at 1e-4, out-of-range
  points and scales included (``tests/test_adamixer.py``);
- ``AdaptiveMixing`` loaded through ``adamixer_convert.load_torch_mixing``
  from the mmdet-idiom twin (``AdaptiveMixingTorch``): 1e-4;
- the whole detector from one JAX ``init`` through
  ``weights.adamixer_state_dict`` (8 queries, 2 stages; content 64 with the
  ``level_proj`` neck, and content 256 without it): per-stage logits and
  boxes within 1e-4 of each output's largest;
- the cost matrices within 1e-4 and the Hungarian assignments equal (a
  flip only at a verified tie);
- ``set_loss`` on the same assignments at rtol 1e-5, every gradient within
  1e-3 of its tensor's largest (two exceptions held to references, see the
  test);
- the mixing block's generators alive at init, an unmatched valid GT
  ignored, and the port of ``test_adamixer_overfits_one_box``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skghoi_tpu.detect import adamixer as J
from skghoi_tpu.oracle.adamixer import AdaptiveMixingTorch, sample_3d_torch
from skghoi_torch.detect import adamixer as P
from skghoi_torch.detect.adamixer_convert import load_torch_mixing
from skghoi_torch.weights import adamixer_state_dict

torch.set_num_threads(2)

CANVAS = (64, 96)
HW = (64.0, 96.0)
SMALL = dict(num_queries=8, num_stages=2, groups=4, in_points=8, out_points=16, ffn_dim=128)


def _rel_close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert got.shape == want.shape and scale > 0 and err <= tol * scale, (name, err, scale)


def test_box_parameterisation_equals_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(10, 100, (20, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, (20, 2))], -1).astype(np.float32)
    xyzr = P.box_to_xyzr(torch.from_numpy(boxes))
    np.testing.assert_allclose(xyzr.numpy(), J.box_to_xyzr(boxes), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(P.xyzr_to_box(xyzr).numpy(), boxes, rtol=1e-5, atol=1e-3)
    deltas = rng.standard_normal((20, 4)).astype(np.float32) * 0.3
    np.testing.assert_allclose(P.apply_deltas(xyzr, torch.from_numpy(deltas)).numpy(),
                               J.apply_deltas(np.asarray(xyzr), deltas), rtol=1e-5, atol=1e-4)
    out = P.xyzr_to_box(P.apply_deltas(P.box_to_xyzr(torch.tensor([[10.0, 20.0, 50.0, 40.0]])),
                                       torch.tensor([[0.5, 0.0, 0.0, 0.0]])))
    np.testing.assert_allclose(out[0].numpy(), [30.0, 20.0, 70.0, 40.0], atol=1e-3)
    np.testing.assert_allclose(P.position_embedding(xyzr, 64).numpy(),
                               J.position_embedding(np.asarray(xyzr), 64), rtol=1e-5, atol=1e-5)


def test_sample_3d_matches_jax_and_oracle():
    rng = np.random.default_rng(1)
    b, n, g, p, c = 2, 5, 2, 7, 8
    pyr = [rng.standard_normal((b, CANVAS[0] // s, CANVAS[1] // s, c)).astype(np.float32)
           for s in (4, 8, 16, 32)]
    pts = np.stack([rng.uniform(-5, CANVAS[1] + 5, (b, n, g, p)),
                    rng.uniform(-5, CANVAS[0] + 5, (b, n, g, p)),
                    rng.uniform(1.5, 5.5, (b, n, g, p))], axis=-1).astype(np.float32)
    got = P.sample_3d([torch.from_numpy(f) for f in pyr], torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, np.asarray(J.sample_3d([jnp.asarray(f) for f in pyr],
                                                           jnp.asarray(pts))), rtol=1e-4, atol=1e-4)
    ref = sample_3d_torch([torch.from_numpy(f) for f in pyr], torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    # The stage's grouped sampling: group g reads channel slice g.
    cg = c // g
    levels = P.group_pyramid([torch.from_numpy(f) for f in pyr], g)
    grouped = P.sample_groups(levels, torch.from_numpy(pts)).numpy()
    for gi in range(g):
        want = J.sample_3d([jnp.asarray(f[..., gi * cg:(gi + 1) * cg]) for f in pyr],
                           jnp.asarray(pts[:, :, gi:gi + 1]))
        np.testing.assert_allclose(grouped[:, :, gi:gi + 1], np.asarray(want), rtol=1e-4, atol=1e-4)


def test_adaptive_mixing_through_load_torch_mixing():
    torch.manual_seed(0)
    rng = np.random.default_rng(2)
    b, n, g, p_in, p_out, c = 2, 4, 2, 5, 6, 16
    twin = AdaptiveMixingTorch(content_dim=c, groups=g, in_points=p_in, out_points=p_out)
    query = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    values = torch.from_numpy(rng.standard_normal((b, n, g, p_in, c // g)).astype(np.float32))
    port = P.AdaptiveMixing(c, g, p_in, p_out)
    port.load_state_dict(load_torch_mixing({f"blk.{k}": v for k, v in twin.state_dict().items()},
                                           prefix="blk."), strict=True)
    with torch.no_grad():
        want = twin(query, values).numpy()
        got = port(query, values).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # LayerNorm at flax's epsilon: the twin's torch default (1e-5) is within 1e-4 here.
    assert port.ln_c.eps == port.ln_s.eps == 1e-6


def test_adaptive_mixing_grads_nonzero_at_init():
    rng = np.random.default_rng(4)
    b, n, g, p_in, p_out, c = 2, 3, 2, 4, 6, 16
    mod = P.AdaptiveMixing(c, g, p_in, p_out)
    mod.reset_generators(torch.Generator().manual_seed(0))
    query = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    values = torch.from_numpy(rng.standard_normal((b, n, g, p_in, c // g)).astype(np.float32))
    values.requires_grad_(True)
    (mod(query, values) ** 2).sum().backward()
    for lin in (mod.channel_mixer, mod.spatial_mixer):
        assert lin.weight.grad.abs().max() > 0
    assert values.grad.abs().max() > 0


def _jax_model(content_dim):
    return J.AdaMixerDetector(num_classes=80, content_dim=content_dim, **SMALL)


@pytest.fixture(scope="module", params=[64, 256], ids=["content64", "content256"])
def setup(request):
    content = request.param
    images = np.random.default_rng(0).uniform(0, 1, (2, *CANVAS, 3)).astype(np.float32)
    model = _jax_model(content)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(images)))
    port = P.AdaMixerDetector(content_dim=content, device="cpu", **SMALL)
    port.load_state_dict(adamixer_state_dict(variables), strict=True)
    assert port.decoder.num_level_proj == (4 if content != 256 else 0)
    return images, model, variables, port


def _gt():
    boxes = np.array([[[10.0, 8.0, 40.0, 50.0], [50.0, 10.0, 90.0, 40.0], [0.0, 0.0, 1.0, 1.0]],
                      [[20.0, 16.0, 60.0, 48.0], [5.0, 30.0, 30.0, 62.0], [60.0, 5.0, 95.0, 30.0]]],
                     np.float32)
    labels = np.array([[49, 7, 0], [3, 49, 3]], np.int64)
    valid = np.array([[True, True, False], [True, True, True]])
    return boxes, labels, valid


def test_forward_equals_jax(setup):
    images, model, variables, port = setup
    want = model.apply(variables, jnp.asarray(images))
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    assert got.cls_logits.shape == (2, 2, 8, 80) and got.boxes.shape == (2, 2, 8, 4)
    for s in range(2):
        _rel_close(got.cls_logits[s].numpy(), want.cls_logits[s], 1e-4, f"logits stage {s}")
        _rel_close(got.boxes[s].numpy(), want.boxes[s], 1e-4, f"boxes stage {s}")


def _assignment_ties(got, want, costs, valid):
    """The (stage, image) cells where two assignments differ, each checked to
    be a tie: both optimal under ``costs`` within 1e-5 of the cost's scale."""
    flips = []
    for s, b in zip(*np.nonzero((got != want).any(-1))):
        c, v = costs[s][b], np.flatnonzero(valid[b])
        gap = sum(c[got[s, b, i], i] for i in v) - sum(c[want[s, b, i], i] for i in v)
        assert abs(gap) <= 1e-5 * np.abs(c).max(), (s, b, got[s, b], want[s, b], gap)
        flips.append((int(s), int(b)))
    return flips


def test_assignments_equal_jax(setup):
    """The costs within 1e-4, and Hungarian on the same cost equal.  The
    matching from each package's own costs (on JAX's outputs, then on the
    port's) may differ only at a tie: at init every stage-0 query starts
    from the whole-image box, and at image seed 0 the two GTs of class 3 of
    image 1 take two stage-0 queries in either order at equal total cost
    (measured gaps 0.0 at content 256 and 1.9e-6 at content 64, the
    costs' largest entries ~9)."""
    images, model, variables, port = setup
    out = jax.tree_util.tree_map(np.asarray, model.apply(variables, jnp.asarray(images)))
    boxes, labels, valid = _gt()
    jout = P.AdaMixerOutputs(torch.from_numpy(np.array(out.cls_logits)),
                             torch.from_numpy(np.array(out.boxes)))
    cost = P.match_cost(jout.cls_logits, jout.boxes, torch.from_numpy(boxes)[None],
                        torch.from_numpy(labels)[None], HW).numpy()
    costs = [[np.asarray(J.match_cost(out.cls_logits[s, b], out.boxes[s, b], boxes[b],
                                      labels[b], HW)) for b in range(2)] for s in range(2)]
    for s in range(2):
        for b in range(2):
            _rel_close(cost[s, b], costs[s][b], 1e-4, f"cost {s} {b}")
            np.testing.assert_array_equal(P.hungarian_match(costs[s][b], valid[b]),
                                          J.hungarian_match(costs[s][b], valid[b]))
    want = J.compute_assignments(out, boxes, labels, valid, HW)
    args = (torch.from_numpy(boxes), torch.from_numpy(labels), torch.from_numpy(valid), HW)
    assert len(_assignment_ties(P.compute_assignments(jout, *args), want, costs, valid)) <= 1
    with torch.no_grad():
        own = P.compute_assignments(port(torch.from_numpy(images)), *args)
    assert len(_assignment_ties(own, want, costs, valid)) <= 1


def _float64(port, variables, content):
    """The port in float64 with the same weights: the reference for the
    gradients that float32 cannot hold to 1e-3 in either package."""
    model = P.AdaMixerDetector(content_dim=content, device="cpu", **SMALL).double()
    model.load_state_dict(adamixer_state_dict(variables), strict=True)
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    model.mean, model.std = model.mean.double(), model.std.double()
    return model


def test_set_loss_and_gradients_equal_jax(setup):
    """The loss at rtol 1e-5 and each gradient within 1e-3 of its tensor's
    largest.  Two exceptions, each held to a reference instead of waived:

    - the attention's key bias shifts every logit of a query's softmax
      alike, so its exact gradient is 0 and both packages give rounding
      noise: it is held at the key weight's scale;
    - the stem and the first bottleneck (all stages train, as in JAX) sum
      the whole 64x96 map's gradient with heavy cancellation: at this seed
      both float32 packages are 2e-3-7e-3 of the tensor's largest from a
      float64 run of the port, so there the float32 port is held within
      1.5x JAX's own distance from that float64 run (plus 1e-4)."""
    images, model, variables, port = setup
    content = port.decoder.init_content_features.shape[1]
    boxes, labels, valid = _gt()
    out = model.apply(variables, jnp.asarray(images))
    assign = J.compute_assignments(out, boxes, labels, valid, HW)
    extra = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
        o = model.apply({"params": p, **extra}, jnp.asarray(images))
        return J.set_loss(o, jnp.asarray(assign), boxes, labels, valid, HW)["set_loss"]

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want_grads = adamixer_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})
    targets = (torch.from_numpy(assign), torch.from_numpy(boxes), torch.from_numpy(labels),
               torch.from_numpy(valid), HW)
    port.zero_grad()
    got = P.set_loss(port(torch.from_numpy(images)), *targets)["set_loss"]
    got.backward()
    assert float(want) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    model64 = _float64(port, variables, content)
    P.set_loss(model64(torch.from_numpy(images).double()), *targets)["set_loss"].backward()
    ref = dict(model64.named_parameters())

    named = dict(port.named_parameters())
    assert len(named) > 80 and named.keys() <= want_grads.keys()
    held_to_float64 = []
    for name, p in named.items():
        g = want_grads[name]
        got_g = torch.zeros_like(p) if p.grad is None else p.grad
        scale = want_grads[name.replace("key.bias", "key.weight")].abs().max().item()
        err = (got_g - g).abs().max().item()
        if err <= 1e-3 * scale:
            continue
        truth = ref[name].grad
        t_scale = truth.abs().max().item()
        jax_err = (g.double() - truth).abs().max().item() / t_scale
        port_err = (got_g.double() - truth).abs().max().item() / t_scale
        assert jax_err > 1e-3 and port_err <= 1.5 * jax_err + 1e-4, (name, err, scale, jax_err,
                                                                        port_err)
        held_to_float64.append(name)
    assert all(n.startswith("backbone.backbone.") for n in held_to_float64), held_to_float64


def test_set_loss_ignores_unmatched_valid_gt():
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 40, (1, 1, 2, 2))
    out = P.AdaMixerOutputs(torch.from_numpy(rng.standard_normal((1, 1, 2, 5)).astype(np.float32)),
                            torch.from_numpy(np.concatenate(
                                [xy, xy + rng.uniform(4, 20, (1, 1, 2, 2))], -1).astype(np.float32)))
    labels, valid = torch.tensor([[1, 2, 3]]), torch.ones(1, 3, dtype=torch.bool)
    assign = torch.tensor([[[0, 1, -1]]])
    base = torch.tensor([[[5.0, 5, 20, 20], [30, 30, 50, 50], [1, 1, 2, 2]]])
    moved = base.clone()
    moved[0, 2] = torch.tensor([500.0, 500, 900, 900])
    l0 = P.set_loss(out, assign, base, labels, valid, HW)["set_loss"].item()
    l1 = P.set_loss(out, assign, moved, labels, valid, HW)["set_loss"].item()
    want = J.set_loss(J.AdaMixerOutputs(out.cls_logits.numpy(), out.boxes.numpy()),
                      assign.numpy(), base.numpy(), labels.numpy(), valid.numpy(), HW)["set_loss"]
    assert np.isfinite(l0)
    np.testing.assert_allclose(l0, l1, rtol=1e-6)
    np.testing.assert_allclose(l0, float(want), rtol=1e-5)


def test_adamixer_overfits_one_box():
    """``tests/test_adamixer.py::test_adamixer_overfits_one_box`` in the port:
    the Hungarian-matched set loss on one image localises the GT box."""
    model = P.AdaMixerDetector(num_classes=80, num_queries=12, num_stages=2, content_dim=64,
                               groups=2, in_points=4, out_points=8, ffn_dim=128, device="cpu")
    images = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, *CANVAS, 3))
                              .astype(np.float32))
    gt_boxes = torch.tensor([[[20.0, 16.0, 60.0, 48.0]]])
    gt_labels, gt_valid = torch.tensor([[7]]), torch.ones(1, 1, dtype=torch.bool)
    opt = torch.optim.Adam(model.parameters(), lr=2e-4)
    first = None
    for _ in range(120):
        opt.zero_grad()
        out = model(images)
        assign = P.compute_assignments(out, gt_boxes, gt_labels, gt_valid, HW)
        loss = P.set_loss(out, torch.from_numpy(assign), gt_boxes, gt_labels, gt_valid,
                          HW)["set_loss"]
        loss.backward()
        opt.step()
        first = loss.item() if first is None else first
    assert loss.item() < first * 0.5, (first, loss.item())
    with torch.no_grad():
        out = model(images)
    logits, boxes = out.cls_logits[-1, 0], out.boxes[-1, 0]
    best = int(logits.amax(1).argmax())
    bb, gt = boxes[best].numpy(), gt_boxes[0, 0].numpy()
    inter = (max(min(bb[2], gt[2]) - max(bb[0], gt[0]), 0)
             * max(min(bb[3], gt[3]) - max(bb[1], gt[1]), 0))
    union = (bb[2] - bb[0]) * (bb[3] - bb[1]) + (gt[2] - gt[0]) * (gt[3] - gt[1]) - inter
    assert inter / union > 0.5, (bb, gt)
    assert int(logits[best].argmax()) == 7

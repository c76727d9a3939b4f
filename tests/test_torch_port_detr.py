"""The port's DETR-R50 held against the JAX package's, on the CPU.

Weights in the facebookresearch/detr layout come from the JAX suite's own
builders (``tests/test_detr.py``):

- ``PackedMHA`` against torch's ``nn.MultiheadAttention`` and JAX's at rtol
  1e-4 / atol 1e-5; two encoder and two decoder layers chained, against
  JAX's, at 1e-4; the sine embedding equal to JAX's (both float64 numpy);
- ``load_torch_detr`` equal bit for bit to JAX's import mapped by
  ``weights.detr_state_dict``; ``hico_head_surgery`` keeps the same rows;
- the whole DETR (2+2 layers, 10 queries, 64x96) from one JAX ``init``:
  logits and boxes within 1e-4 of each output's largest, the post-processed
  boxes, labels and scores too;
- ``detr_set_loss`` on shared assignments at rtol 1e-5, every gradient
  within 1e-3 of its tensor's largest; ``detr_assignments`` equal;
- the port of ``test_detr_finetune_overfits_one_box``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skghoi_tpu.detect import detr as J
from skghoi_torch.detect import detr as P
from skghoi_torch.weights import detr_state_dict
from test_detr import dec_layer_sd, enc_layer_sd, flax_mha_params, mha_params, synth_detr_state_dict

torch.set_num_threads(2)

CANVAS = (64, 96)
D = 256


def _rel_close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert got.shape == want.shape and scale > 0 and err <= tol * scale, (name, err, scale)


def _mha(sd, prefix):
    m = P.PackedMHA()
    m.load_state_dict({"in_proj_weight": sd[prefix + ".in_proj_weight"],
                       "in_proj_bias": sd[prefix + ".in_proj_bias"],
                       "out_proj.weight": sd[prefix + ".out_proj.weight"],
                       "out_proj.bias": sd[prefix + ".out_proj.bias"]})
    return m


def test_packed_mha_matches_torch_and_jax():
    rng = np.random.default_rng(0)
    sd = {}
    mha_params(rng, "attn", sd)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((2, 7, D), (2, 9, D), (2, 9, D)))
    ref = torch.nn.MultiheadAttention(D, 8, batch_first=True)
    ref.load_state_dict({n: sd["attn." + n] for n in ("in_proj_weight", "in_proj_bias",
                                                      "out_proj.weight", "out_proj.bias")})
    with torch.no_grad():
        want, _ = ref.eval()(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
        got = _mha(sd, "attn")(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    jax_out = J.PackedMHA().apply({"params": flax_mha_params(sd, "attn")}, q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=1e-4, atol=1e-5)


def test_encoder_decoder_stack_matches_jax():
    rng = np.random.default_rng(1)
    sd = {}
    for i in range(2):
        enc_layer_sd(rng, f"transformer.encoder.layers.{i}", sd)
        dec_layer_sd(rng, f"transformer.decoder.layers.{i}", sd)
    src, pos = (rng.standard_normal((1, 40, D)).astype(np.float32) for _ in range(2))
    qpos = rng.standard_normal((1, 10, D)).astype(np.float32)

    port = P.load_torch_detr({**synth_detr_state_dict(rng), **sd})
    jv = J.load_torch_detr({**synth_detr_state_dict(np.random.default_rng(2)), **sd})["params"]
    x, t = torch.from_numpy(src), torch.zeros(1, 10, D)
    jx, jt = jnp.asarray(src), jnp.zeros((1, 10, D))
    with torch.no_grad():
        for i in range(2):
            layer = P.EncoderLayer()
            layer.load_state_dict({k[len(f"encoder.{i}."):]: v for k, v in port.items()
                                   if k.startswith(f"encoder.{i}.")})
            x = layer(x, torch.from_numpy(pos))
            jx = J.EncoderLayer().apply({"params": jv[f"enc{i}"]}, jx, pos)
        for i in range(2):
            layer = P.DecoderLayer()
            layer.load_state_dict({k[len(f"decoder.{i}."):]: v for k, v in port.items()
                                   if k.startswith(f"decoder.{i}.")})
            t = layer(t, x, torch.from_numpy(pos), torch.from_numpy(qpos))
            jt = J.DecoderLayer().apply({"params": jv[f"dec{i}"]}, jt, jx, pos, qpos)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw", [(7, 9), (26, 42)])
def test_sine_position_embedding_equals_jax(hw):
    np.testing.assert_allclose(P.sine_position_embedding(*hw), J.sine_position_embedding(*hw),
                               rtol=1e-5, atol=1e-5)


def test_load_torch_detr_and_surgery_equal_jax():
    sd = synth_detr_state_dict(np.random.default_rng(3))
    for src in (sd, P.hico_head_surgery(sd)):
        got = P.load_torch_detr(src)
        want = detr_state_dict(jax.tree_util.tree_map(np.asarray, J.load_torch_detr(src)))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    cut = P.hico_head_surgery(sd)
    jcut = J.hico_head_surgery(sd)
    assert cut["class_embed.weight"].shape == (81, D)
    for t in ("weight", "bias"):
        np.testing.assert_array_equal(cut[f"class_embed.{t}"].numpy(),
                                      np.asarray(jcut[f"class_embed.{t}"]))
    assert P.DETR_SURGERY_KEEP == J.DETR_SURGERY_KEEP and P.HICO_TO_DETR80 == J.HICO_TO_DETR80
    P.DETR(num_classes=80, device="cpu").load_state_dict(P.load_torch_detr(cut), strict=True)


@pytest.fixture(scope="module")
def setup():
    images = np.random.default_rng(0).uniform(-1, 1, (2, *CANVAS, 3)).astype(np.float32)
    sizes = np.array([[64.0, 96.0], [50.0, 80.0]], np.float32)
    model = J.DETR(num_classes=80, num_layers=2, num_queries=10)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(sizes)))
    port = P.DETR(num_classes=80, num_layers=2, num_queries=10, device="cpu")
    port.load_state_dict(detr_state_dict(variables), strict=True)
    return images, sizes, model, variables, port


def test_forward_equals_jax(setup):
    images, sizes, model, variables, port = setup
    want = model.apply(variables, jnp.asarray(images), method=J.DETR.raw)
    with torch.no_grad():
        got = port.raw(torch.from_numpy(images))
    for g, w, name in zip(got, want, ("logits", "boxes")):
        _rel_close(g.numpy(), w, 1e-4, name)
    want = model.apply(variables, jnp.asarray(images), jnp.asarray(sizes))
    got = port(torch.from_numpy(images), torch.from_numpy(sizes))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4)


def _gt():
    boxes = np.array([[[0.4, 0.5, 0.35, 0.4], [0.7, 0.3, 0.2, 0.3], [0.1, 0.1, 0.1, 0.1]],
                      [[0.3, 0.6, 0.3, 0.5], [0.5, 0.5, 0.9, 0.9], [0.6, 0.2, 0.2, 0.2]]],
                     np.float32)
    labels = np.array([[7, 0, 3], [49, 3, 3]], np.int64)
    valid = np.array([[True, True, False], [True, True, True]])
    return boxes, labels, valid


def test_set_loss_and_gradients_equal_jax(setup):
    images, _, model, variables, port = setup
    boxes, labels, valid = _gt()
    extra = {k: v for k, v in variables.items() if k != "params"}
    logits, pred = model.apply(variables, jnp.asarray(images), method=J.DETR.raw)
    assign = J.detr_assignments(logits, pred, boxes, labels, valid)
    got_assign = P.detr_assignments(torch.from_numpy(np.array(logits)),
                                    torch.from_numpy(np.array(pred)), torch.from_numpy(boxes),
                                    torch.from_numpy(labels), torch.from_numpy(valid))
    np.testing.assert_array_equal(got_assign, assign)

    def loss_fn(p):
        lg, bx = model.apply({"params": p, **extra}, jnp.asarray(images), method=J.DETR.raw)
        losses = J.detr_set_loss(lg, bx, jnp.asarray(assign), boxes, labels, valid)
        return sum(losses.values()), losses

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    want_grads = detr_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})
    port.zero_grad()
    got = P.detr_set_loss(*port.raw(torch.from_numpy(images)), torch.from_numpy(assign),
                          torch.from_numpy(boxes), torch.from_numpy(labels),
                          torch.from_numpy(valid))
    sum(got.values()).backward()
    for k in want:
        assert float(want[k]) > 0
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
    named = dict(port.named_parameters())
    assert len(named) > 80 and named.keys() <= want_grads.keys()
    for name, p in named.items():
        g = want_grads[name]
        got_g = torch.zeros_like(p) if p.grad is None else p.grad
        err, scale = (got_g - g).abs().max().item(), g.abs().max().item()
        assert err <= 1e-3 * max(scale, 1e-12), (name, err, scale)


def test_detr_finetune_overfits_one_box():
    """``tests/test_detr.py::test_detr_finetune_overfits_one_box`` in the
    port: Hungarian-matched CE + L1 + GIoU on one image localises the box."""
    model = P.DETR(num_classes=80, num_layers=2, num_queries=10, device="cpu")
    images = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, *CANVAS, 3))
                              .astype(np.float32))
    gt_boxes = torch.tensor([[[0.4, 0.5, 0.35, 0.4]]])
    gt_labels, gt_valid = torch.tensor([[7]]), torch.ones(1, 1, dtype=torch.bool)
    opt = torch.optim.Adam(model.parameters(), lr=3e-4)
    first = None
    for _ in range(120):
        opt.zero_grad()
        logits, boxes = model.raw(images)
        assign = P.detr_assignments(logits, boxes, gt_boxes, gt_labels, gt_valid)
        loss = sum(P.detr_set_loss(logits, boxes, torch.from_numpy(assign), gt_boxes, gt_labels,
                                   gt_valid).values())
        loss.backward()
        opt.step()
        first = loss.item() if first is None else first
    assert loss.item() < first * 0.5, (first, loss.item())
    with torch.no_grad():
        logits, boxes = model.raw(images)
    probs = torch.softmax(logits, -1)[0, :, :-1]
    best = int(probs.amax(1).argmax())
    assert int(probs[best].argmax()) == 7
    assert (boxes[0, best] - gt_boxes[0, 0]).abs().max() < 0.1, (boxes[0, best], gt_boxes[0, 0])

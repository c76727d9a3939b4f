"""The port's SCG eval forward held against the JAX package's, same weights.

One JAX initialisation of the full-width network (64x96 canvas, batch 2) is
shared by every test here: the synthetic batch, the weight import in both
ResNet layouts, the P2..P5 pyramid and the whole eval forward.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from skghoi_tpu.models import SpatiallyConditionedGraph as JaxSCG
from skghoi_tpu.models.backbone import DetectorBackbone as JaxBackbone
from skghoi_tpu.models.backbone import convert_resnet_block_layout
from skghoi_torch.entry import build_model, make_batch, verb_mask
from skghoi_torch.models.backbone import DetectorBackbone
from skghoi_torch.weights import to_state_dict

torch.set_num_threads(2)

CANVAS = (64, 96)


@pytest.fixture(scope="module")
def jax_setup():
    batch = graft._make_batch(2, CANVAS)
    ovm = graft._verb_mask()
    model = JaxSCG()
    variables = jax.jit(lambda r, b: model.init(r, b, ovm, training=False))(
        jax.random.PRNGKey(0), batch)
    return batch, ovm, jax.tree_util.tree_map(np.asarray, variables)


def _port_batch():
    return make_batch(2, CANVAS, device="cpu"), verb_mask(device="cpu")


def test_make_batch_matches_jax(jax_setup):
    jbatch, jovm, _ = jax_setup
    batch, ovm = _port_batch()
    for name in ("images", "image_sizes", "det_boxes", "det_labels", "det_scores", "det_valid"):
        np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)), err_msg=name)
    np.testing.assert_array_equal(ovm.numpy(), np.asarray(jovm))


def test_weights_both_resnet_layouts(jax_setup):
    _, _, variables = jax_setup
    scanned = to_state_dict(variables)
    unrolled = to_state_dict(convert_resnet_block_layout(variables, to_scan=False))
    assert "detector.backbone.layer3.5.conv2.weight" in scanned
    assert scanned.keys() == unrolled.keys()
    for k in scanned:
        assert torch.equal(scanned[k], unrolled[k]), k

    model = build_model(device="cpu")
    model.load_state_dict(scanned, strict=True)
    # The conv kernel moved HWIO -> OIHW, the dense kernel was transposed.
    bb = variables["params"]["detector"]["backbone"]
    np.testing.assert_array_equal(model.detector.backbone.conv1.weight.detach().numpy(),
                                  bb["stem_conv"]["kernel"].transpose(3, 2, 0, 1))
    gh = variables["params"]["interaction_head"]["box_pair_head"]
    np.testing.assert_array_equal(
        model.interaction_head.box_pair_head.box_head_fc1.weight.detach().numpy(),
        gh["box_head_fc1"]["kernel"].T)


def test_backbone_pyramid_matches(jax_setup):
    jbatch, _, variables = jax_setup
    det = {col: variables[col]["detector"] for col in ("params", "batch_stats")}
    want = JaxBackbone(frozen_stages=1).apply(det, jbatch.images)

    port = DetectorBackbone(device="cpu")
    sd = {k[len("detector."):]: v for k, v in to_state_dict(variables).items()
          if k.startswith("detector.")}
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(np.asarray(jbatch.images)))
    for l, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"P{l + 2}")


@pytest.mark.parametrize("feedback,quirk", [(False, False), (True, True)])
def test_eval_forward_matches(jax_setup, feedback, quirk):
    jbatch, jovm, variables = jax_setup
    jmodel = JaxSCG(feedback=feedback, quirk_box_index_tails=quirk)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, jovm, training=False))(variables, jbatch)

    model = build_model(device="cpu", feedback=feedback, quirk_box_index_tails=quirk)
    model.load_state_dict(to_state_dict(variables), strict=True)
    batch, ovm = _port_batch()
    with torch.no_grad():
        got = model(batch, ovm)

    assert got.scores.shape == (2, 15, 30, 117)
    for name in ("boxes", "n_h", "n", "object_class", "pair_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert (got.scores > 0).any(), "no scored pair: the comparison would be vacuous"
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-4)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights), atol=1e-4)
    np.testing.assert_allclose(got.prior.numpy(), np.asarray(want.prior), atol=1e-6)

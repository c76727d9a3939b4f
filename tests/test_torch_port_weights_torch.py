"""Torch-format weight import held against the JAX package's, on the CPU.

- ``weights.load_torch_resnet50``: a seeded torchvision-named ResNet-50 under
  each prefix the loaders use (``""``, ``backbone.body.``, ``backbone.``,
  ``detector_backbone.``), beside keys it must drop (``fc``,
  ``num_batches_tracked``, other prefixes), loads strictly into the port's
  ResNet-50, whose C2..C5 equal JAX's ``load_torch_resnet50`` + ``ResNet50``
  within 1e-4 of each level's largest, in both of JAX's block layouts
  (scanned and unrolled).
- ``weights.from_reference_state_dict``: one seeded
  ``skghoi_tpu.oracle.twin.SpatiallyConditionedGraphTwin`` ``state_dict``
  (the reference checkpoint's key families) goes into the port through it and
  into JAX through ``oracle.convert.to_flax_variables``; on the same 64x96
  batch the eval scores agree within atol 1e-4
  (``tests/test_reference_parity.py``'s bound) and the training losses, with
  the same Gumbel noise, within rtol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from skghoi_tpu.models import SpatiallyConditionedGraph as JaxSCG
from skghoi_tpu.models.backbone import load_torch_resnet50 as jax_load_torch_resnet50
from skghoi_tpu.models.resnet import ResNet50 as JaxResNet50
from skghoi_tpu.oracle.convert import to_flax_variables
from skghoi_torch.detect.frcnn import random_state_dict
from skghoi_torch.entry import build_model, make_batch, verb_mask
from skghoi_torch.models.resnet import ResNet50
from skghoi_torch.weights import from_reference_state_dict, load_torch_resnet50
from test_reference_parity import build_twin, make_inputs

torch.set_num_threads(2)

CANVAS = (64, 96)
PREFIXES = ["", "backbone.body.", "backbone.", "detector_backbone."]


def _resnet_state_dict():
    """The torchvision ResNet-50 of a seeded random detector checkpoint."""
    body = "backbone.body."
    return {k[len(body):]: v for k, v in random_state_dict(4).items() if k.startswith(body)}


@pytest.fixture(scope="module")
def resnet_case():
    sd = _resnet_state_dict()
    image = np.random.default_rng(5).standard_normal((1, *CANVAS, 3)).astype(np.float32)
    want = {}
    for scan in (True, False):
        params, stats = jax_load_torch_resnet50(sd, prefix="", scan_blocks=scan)
        fn = jax.jit(lambda v, x, scan=scan: JaxResNet50(scan_blocks=scan).apply(v, x))
        want[scan] = [np.asarray(c) for c in fn({"params": params, "batch_stats": stats}, image)]
    return sd, image, want


@pytest.mark.parametrize("prefix", PREFIXES, ids=lambda p: p or "none")
def test_load_torch_resnet50_matches_jax(resnet_case, prefix):
    sd, image, want = resnet_case
    full = {prefix + k: v for k, v in sd.items()}
    full[prefix + "fc.weight"] = torch.zeros(1000, 2048)
    full["roi_heads.box_head.fc6.weight"] = torch.zeros(1, 1)  # outside every prefix
    loaded = load_torch_resnet50(full, prefix=prefix)
    assert not any(k.endswith("num_batches_tracked") or k.startswith("fc.") for k in loaded)
    model = ResNet50()
    model.load_state_dict(loaded, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(image).permute(0, 3, 1, 2))
    for scan, levels in want.items():
        jv = jax_load_torch_resnet50(full, prefix=prefix, scan_blocks=scan)
        assert jv[0]["stem_conv"]["kernel"].shape == (7, 7, 3, 64)
        for level, (g, w) in enumerate(zip(got, levels)):
            g = g.permute(0, 2, 3, 1).numpy()
            err, scale = np.abs(g - w).max(), np.abs(w).max()
            assert g.shape == w.shape and err <= 1e-4 * scale, (scan, level, err, scale)


def test_load_torch_resnet50_names_a_missing_prefix():
    with pytest.raises(KeyError, match="backbone.body."):
        load_torch_resnet50(_resnet_state_dict(), prefix="backbone.body.")


@pytest.fixture(scope="module")
def twin_case():
    _, _, object_to_action = make_inputs()
    sd = build_twin(object_to_action).state_dict()
    port = build_model(device="cpu")
    port.load_state_dict(from_reference_state_dict(sd), strict=True)
    return sd, port


def test_reference_keys_all_used(twin_case):
    sd, port = twin_case
    got = from_reference_state_dict(sd)
    assert got.keys() == port.state_dict().keys()
    fc1 = sd["interaction_head.box_pair_head.box_head.1.weight"]
    # channel-major [C, 7, 7] input -> the port's (7, 7, C): input (y, x, c) = (1, 2, 3)
    port_fc1 = got["interaction_head.box_pair_head.box_head_fc1.weight"]
    assert torch.equal(port_fc1[:, (1 * 7 + 2) * 256 + 3], fc1[:, 3 * 49 + 1 * 7 + 2])
    mbf = "interaction_head.box_pair_head.sub_to_obj"
    assert torch.equal(got[f"{mbf}.w2"][5], sd[f"{mbf}.fc_2.5.weight"].T)
    no_transh = {k: v for k, v in sd.items() if ".transh." not in k}
    missing = set(got) - set(from_reference_state_dict(no_transh))
    assert missing == {f"interaction_head.box_pair_head.transh.{t}.weight"
                       for t in ("ent_embeddings", "rel_embeddings", "norm_vector")}


def test_reference_checkpoint_scores_and_losses_match_jax(twin_case):
    sd, port = twin_case
    variables = to_flax_variables(sd)
    jbatch, jovm = graft._make_batch(2, CANVAS, with_targets=True), graft._verb_mask()
    model = JaxSCG()
    rng = jax.random.PRNGKey(7)
    want_eval = jax.jit(lambda v, b: model.apply(v, b._replace(targets=None), jovm,
                                                 training=False))(variables, jbatch)
    want_train = jax.jit(lambda v, b: model.apply(v, b, jovm, training=True, rng=rng))(
        variables, jbatch)
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(rng, (2, 15 * 30 * 117))))

    batch, ovm = make_batch(2, CANVAS, with_targets=True, device="cpu"), verb_mask(device="cpu")
    with torch.no_grad():
        got_eval = port(batch._replace(targets=None), ovm)
        got_train = port(batch, ovm, training=True, gumbel=gumbel)
    np.testing.assert_array_equal(got_eval.boxes.numpy(), np.asarray(want_eval.boxes))
    assert np.asarray(want_eval.scores).max() > 0
    np.testing.assert_allclose(got_eval.scores.numpy(), np.asarray(want_eval.scores), rtol=0,
                               atol=1e-4)
    for k, v in want_train.losses.items():
        assert float(v) > 0, f"{k} is 0: the comparison would be vacuous"
        np.testing.assert_allclose(float(got_train.losses[k]), float(v), rtol=1e-5, err_msg=k)

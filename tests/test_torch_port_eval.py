"""The port's HICO-DET evaluation held against the JAX package's, on the CPU.

``ops/ap.py`` on the probes of ``tests/test_ap.py`` (exact);
``unpack_image_results`` on the same numpy outputs (exact);
``evaluate_hicodet`` of the full-width SCG with the JAX variables carried
over by ``to_state_dict``, on a synthetic split at 64x96: full, rare and
non-rare mAP within 1e-4 of JAX's; the ``.mat`` files of
``cache_hicodet_mat`` and the V-COCO pickle rows equal to JAX's on the same
outputs; ``to_numpy``.  One JAX initialisation and one compile of the JAX
eval step serve the file.
"""

import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from skghoi_tpu.data.factory import DataFactory as JaxDataFactory
from skghoi_tpu.data.factory import HOILoader as JaxHOILoader
from skghoi_tpu.data.hicodet import HICODet as JaxHICODet
from skghoi_tpu.data.synthetic import make_synthetic_hicodet, make_synthetic_vcoco
from skghoi_tpu.data.vcoco import VCOCO as JaxVCOCO
from skghoi_tpu.eval import cache as jcache
from skghoi_tpu.eval import hoi_eval as jeval
from skghoi_tpu.models import SpatiallyConditionedGraph as JaxSCG
from skghoi_tpu.models.interaction_head import InteractionOutputs as JaxOutputs
from skghoi_tpu.ops import ap as jap
from skghoi_tpu.parallel.train_step import build_eval_step as jax_build_eval_step
from skghoi_torch import constants as C
from skghoi_torch.data.factory import DataFactory, HOILoader, to_device
from skghoi_torch.data.hicodet import HICODet
from skghoi_torch.data.vcoco import VCOCO
from skghoi_torch.entry import build_model
from skghoi_torch.eval import cache, hoi_eval
from skghoi_torch.models.interaction_head import InteractionOutputs
from skghoi_torch.ops import ap
from skghoi_torch.parallel.train_step import build_eval_step
from skghoi_torch.weights import to_state_dict

torch.set_num_threads(2)

SMALL = dict(min_size=64, max_size=107, canvas_landscape=(64, 96), canvas_portrait=(96, 64))
INIT_KEY = 6


# --- the AP meters: tests/test_ap.py's probes, both packages ----------------

AP_PROBES = [  # (scores, labels, num_gt)
    ([0.9, 0.8, 0.7, 0.2, 0.1], [1, 1, 1, 0, 0], 3),
    ([0.9, 0.8, 0.7], [1, 0, 1], 2),
    ([0.9], [1.0], 2),
    ([0.5, 0.5, 0.5, 0.4], [0, 1, 1, 0], 3),  # ties keep index order
    ([0.3, 0.9, 0.6, 0.1], [0, 0, 0, 0], 2),
    ([], [], 4),
    ([0.9, 0.8], [1, 1], None),
]


@pytest.mark.parametrize("algorithm", ["11P", "INT"])
@pytest.mark.parametrize("probe", range(len(AP_PROBES)))
def test_average_precision_equal(algorithm, probe):
    scores, labels, num_gt = (np.asarray(x, np.float64) if isinstance(x, list) else x
                              for x in AP_PROBES[probe])
    want = jap.average_precision(scores, labels, num_gt, algorithm)
    assert ap.average_precision(scores, labels, num_gt, algorithm) == want


def test_known_ap_values():
    """tests/test_ap.py's hand-computed values."""
    s, lab = np.asarray([0.9, 0.8, 0.7]), np.asarray([1, 0, 1])
    np.testing.assert_allclose(ap.average_precision(s, lab, 2, "11P"), (6 + 5 * 2 / 3) / 11,
                               rtol=1e-9)
    np.testing.assert_allclose(ap.average_precision(s, lab, 2, "INT"), 0.5 + 0.5 * 2 / 3,
                               rtol=1e-9)
    np.testing.assert_allclose(ap.average_precision(np.asarray([0.9]), np.asarray([1.0]), 2),
                               6 / 11, rtol=1e-9)


def test_meter_equal():
    rng = np.random.default_rng(0)
    meters = [m.DetectionAPMeter(5, num_gt=[3, 0, 2, 4, 1], algorithm="11P") for m in (jap, ap)]
    for _ in range(4):
        args = (rng.uniform(size=9), rng.integers(0, 5, 9), rng.integers(0, 2, 9))
        for meter in meters:
            meter.append(*args)
    np.testing.assert_array_equal(meters[1].eval(), meters[0].eval())
    meters[1].reset()
    assert not meters[1].eval().any()


def test_association_equal():
    rng = np.random.default_rng(1)
    gt_h, gt_o = rng.uniform(0, 50, (2, 4, 4))
    gt_h[:, 2:] += gt_h[:, :2] + 10
    gt_o[:, 2:] += gt_o[:, :2] + 10
    det_h = np.concatenate([gt_h + rng.normal(0, 2, gt_h.shape), gt_h + 40])
    det_o = np.concatenate([gt_o + rng.normal(0, 2, gt_o.shape), gt_o])
    scores = rng.uniform(size=8)
    want = jap.BoxPairAssociation(0.5)((gt_h, gt_o), (det_h, det_o), scores)
    got = ap.BoxPairAssociation(0.5)((gt_h, gt_o), (det_h, det_o), scores)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < 8
    np.testing.assert_array_equal(ap.BoxAssociation(0.5)(gt_h, det_h, scores),
                                  jap.BoxAssociation(0.5)(gt_h, det_h, scores))
    empty = ap.BoxPairAssociation()((np.zeros((0, 4)), np.zeros((0, 4))),
                                    (det_h, det_o), scores)
    assert not empty.any()


# --- unpacking and caching on the same numpy outputs ---------------------------

def _numpy_outputs(rng, b, h=3, n=5, k=C.HICO_NUM_VERBS, num_object=C.HICO_NUM_OBJECTS):
    prior = (rng.uniform(size=(b, 2, h, n, k)) < 0.05) * rng.uniform(size=(b, 2, h, n, k))
    return dict(
        scores=rng.uniform(size=(b, h, n, k)).astype(np.float32),
        logits_p=rng.normal(size=(b, h, n, k)).astype(np.float32),
        weights=rng.uniform(size=(b, h, n)).astype(np.float32),
        prior=prior.astype(np.float32),
        pair_valid=rng.uniform(size=(b, h, n)) < 0.7,
        boxes=np.sort(rng.uniform(0, 90, (b, n, 4)), axis=-1).astype(np.float32)[..., [0, 2, 1, 3]],
        object_class=rng.integers(0, num_object, (b, n)),
        n_h=np.full(b, h), n=np.full(b, n),
    )


class _Batch:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_unpack_image_results_equal():
    rng = np.random.default_rng(2)
    outs = _numpy_outputs(rng, 2)
    batch = _Batch(image_sizes=np.asarray([[64.0, 85.0], [50.0, 96.0]], np.float32),
                   original_sizes=np.asarray([[120.0, 160.0], [90.0, 173.0]], np.float32))
    for slot in range(2):
        for keep in (None, 7):
            want = jeval.unpack_image_results(JaxOutputs(**outs), batch, slot, keep)
            got = hoi_eval.unpack_image_results(InteractionOutputs(**outs), batch, slot, keep)
            assert got.keys() == want.keys() and len(got["scores"]) > 0
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _replay(outputs):
    it = iter(outputs)
    return lambda params, batch: next(it)


@pytest.fixture(scope="module")
def hico_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_synth"))
    try:
        make_synthetic_hicodet(root, "test2015", num_images=6, seed=7)
        yield root
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _hico(cls, root):
    return cls(os.path.join(root, "hico_20160224_det/images/test2015"),
               os.path.join(root, "instances_test2015.json"))


def test_cache_hicodet_mat_equal(hico_root, tmp_path):
    rng = np.random.default_rng(3)
    datasets = _hico(JaxHICODet, hico_root), _hico(HICODet, hico_root)
    batches = [[0, 1, 2], [3, 4, 5]]
    outs = [_numpy_outputs(rng, 3) for _ in batches]
    sizes = [np.asarray([datasets[0].image_size(i)[::-1] for i in b], np.float32) for b in batches]
    loader = [(_Batch(image_sizes=s * 0.5, original_sizes=s), b) for s, b in zip(sizes, batches)]
    coco2hico = jcache.build_coco_to_hico(datasets[0].objects, datasets[0].objects)
    assert cache.build_coco_to_hico(datasets[1].objects, datasets[1].objects) == coco2hico
    jcache.cache_hicodet_mat(_replay([JaxOutputs(**o) for o in outs]), None, loader, datasets[0],
                             coco2hico, str(tmp_path / "jax"))
    cache.cache_hicodet_mat(_replay([InteractionOutputs(**o) for o in outs]), None, loader,
                            datasets[1], coco2hico, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 80
    rows = 0
    for name in names:
        want = sio.loadmat(str(tmp_path / "jax" / name))["all_boxes"]
        got = sio.loadmat(str(tmp_path / "port" / name))["all_boxes"]
        assert got.shape == want.shape and got.dtype == want.dtype
        for a, b in zip(got.flat, want.flat):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)
            rows += len(a)
    assert rows > 0


def test_cache_vcoco_pkl_equal(tmp_path):
    root = str(tmp_path / "vcoco")
    make_synthetic_vcoco(root, "test", num_images=4, seed=1)
    datasets = [cls(os.path.join(root, "mscoco2014/val2014"),
                    os.path.join(root, "instances_vcoco_test.json")) for cls in (JaxVCOCO, VCOCO)]
    rng = np.random.default_rng(4)
    outs = [_numpy_outputs(rng, 2, k=C.VCOCO_NUM_ACTIONS) for _ in range(2)]
    sizes = np.asarray([[120.0, 160.0]] * 2, np.float32)
    loader = [(_Batch(image_sizes=sizes, original_sizes=sizes), b) for b in ([0, 1], [2, 3])]
    want = jcache.cache_vcoco_pkl(_replay([JaxOutputs(**o) for o in outs]), None, loader,
                                  datasets[0], str(tmp_path / "jax"))
    got = cache.cache_vcoco_pkl(_replay([InteractionOutputs(**o) for o in outs]), None, loader,
                                datasets[1], str(tmp_path / "port"))
    with open(want, "rb") as f:
        want_rows = pickle.load(f)
    with open(got, "rb") as f:
        got_rows = pickle.load(f)
    assert len(got_rows) == len(want_rows) > 0
    assert [dict(r) for r in got_rows] == [dict(r) for r in want_rows]


def test_to_numpy():
    out = InteractionOutputs(
        scores=torch.ones(2, 3, dtype=torch.bfloat16) / 3, logits_p=torch.zeros(1),
        weights=torch.zeros(1), prior=torch.zeros(1), pair_valid=torch.ones(2, dtype=torch.bool),
        boxes=torch.zeros(1, 4), object_class=torch.arange(3), n_h=torch.zeros(1),
        n=torch.zeros(1), losses={"hoi_loss": torch.tensor(1.5, requires_grad=True) * 2},
        metrics={"transh_pos_dropped": torch.tensor(0.0)})
    host = hoi_eval.to_numpy(out)
    assert isinstance(host, InteractionOutputs) and host.labels is None
    assert host.scores.dtype == np.float32 and host.pair_valid.dtype == bool
    np.testing.assert_array_equal(host.scores, out.scores.float().numpy())
    assert host.object_class.dtype == np.int64 and float(host.losses["hoi_loss"]) == 3.0
    assert isinstance(host.metrics["transh_pos_dropped"], np.ndarray)


# --- the whole evaluation: the network with JAX's weights ----------------------

@pytest.fixture(scope="module")
def map_pair(hico_root):
    """(JAX result, port result): ``evaluate_hicodet`` over the same split
    with the same weights, batch 4 (a short last batch)."""
    jf = JaxDataFactory("hicodet", "test2015", hico_root,
                        os.path.join(hico_root, "detections_test2015"), **SMALL)
    pf = DataFactory("hicodet", "test2015", hico_root,
                     os.path.join(hico_root, "detections_test2015"), **SMALL)
    jloader = JaxHOILoader(jf, 4, shuffle=False, with_targets=False)
    ploader = HOILoader(pf, 4, shuffle=False, with_targets=False)
    ovm = jf.dataset.object_verb_mask()
    first, _ = next(iter(jloader))
    model = JaxSCG()
    variables = jax.jit(lambda r, b: model.init(r, b, jnp.asarray(ovm), training=False))(
        jax.random.PRNGKey(INIT_KEY), first)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params = variables["params"]
    extra = {k: v for k, v in variables.items() if k != "params"}
    jstep = jax_build_eval_step(model, ovm)
    want = jeval.evaluate_hicodet(lambda p, b: jstep(p, extra, b), params, jloader, jf.dataset,
                                  log_fn=lambda s: None)

    port = build_model(device="cpu")
    port.load_state_dict(to_state_dict(variables), strict=True)
    step = build_eval_step(port, torch.from_numpy(ovm))
    got = hoi_eval.evaluate_hicodet(lambda p, b: step(to_device(b, "cpu")), None, ploader,
                                    pf.dataset, log_fn=lambda s: None)
    return want, got


def test_evaluate_hicodet_map_matches_jax(map_pair):
    want, got = map_pair
    assert want["full"] > 0, "a zero mAP would make the comparison vacuous"
    for key in ("full", "rare", "non_rare"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4, err_msg=key)
    assert got["ap"].shape == (C.HICO_NUM_INTERACTIONS,)
    np.testing.assert_allclose(got["ap"], want["ap"], rtol=0, atol=1e-4)

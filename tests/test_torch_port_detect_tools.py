"""The port's stage-1 detection tools held against the JAX package's, on the CPU.

- ``generate_gt_detections`` and ``generate_model_detections`` (a fixed
  detector, a COCO->HICO label map) write the same JSON bytes as JAX's.
- ``compute_detection_map`` over the synthetic dataset's cached detections
  equals JAX's within 1e-6 (mAP, mean max recall, per-class AP).
- ``tools.preprocess_detections.main(["--cpu", ...])`` with a seeded random
  torchvision-layout checkpoint (``torch.save``, read back with
  ``weights_only=True``) on two ``data/synthetic.py`` images writes the same
  JSON files as the JAX CLI: boxes and scores within 1e-4 (rtol and atol),
  labels equal.  A small envelope (``--min-size 96 --max-size 160 --canvas
  128 192``) keeps the CPU run short; ``--score-thresh 0`` because random
  weights give class probabilities near 1/91, under the default 0.05.
  Weight seed 2 has no near-tie between the two packages' scores.
- ``--detector detr|adamixer`` without ``--cpu`` raise without a card
  (their caches are held to JAX's in ``test_torch_port_train_detector.py``).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from skghoi_tpu.data.hicodet import HICODet as JaxHICODet
from skghoi_tpu.data.synthetic import make_synthetic_hicodet
from skghoi_tpu.detect import compute_detection_map as jax_compute_detection_map
from skghoi_tpu.detect import generate_gt_detections as jax_generate_gt_detections
from skghoi_tpu.detect.generate import generate_model_detections as jax_generate_model_detections
from skghoi_tpu.tools import preprocess_detections as jax_preprocess
from skghoi_torch.data.hicodet import HICODet
from skghoi_torch.detect import compute_detection_map, generate_gt_detections
from skghoi_torch.detect.frcnn import random_state_dict
from skghoi_torch.detect.generate import generate_model_detections
from skghoi_torch.tools import preprocess_detections

torch.set_num_threads(2)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed when the test ends, passed or failed:
    pytest keeps the directories of its last three runs, and a Faster R-CNN
    checkpoint is about 160 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


PART = "train2015"
WEIGHT_SEED = 2


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("detect_synth"))
    try:
        make_synthetic_hicodet(root, PART, num_images=6, seed=3)
        yield root
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _datasets(root):
    kw = dict(root=os.path.join(root, f"hico_20160224_det/images/{PART}"),
              anno_file=os.path.join(root, f"instances_{PART}.json"))
    return HICODet(**kw), JaxHICODet(**kw)


def _files(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = f.read()
    return out


def test_generate_gt_detections_same_bytes(root, tmp_path):
    port, jds = _datasets(root)
    generate_gt_detections(port, str(tmp_path / "port"))
    jax_generate_gt_detections(jds, str(tmp_path / "jax"))
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert len(want) == 6 and got == want


def test_generate_model_detections_same_bytes(root, tmp_path):
    port, jds = _datasets(root)

    def detector(arr):
        rng = np.random.default_rng(int(arr.sum() * 1000) % 2**32)
        boxes = rng.uniform(0, 100, (12, 4))
        boxes[:, 2:] += boxes[:, :2]
        return boxes, rng.integers(1, 91, 12), rng.uniform(0, 1, 12)

    label_map = {str(i): i - 1 for i in range(1, 81)}
    generate_model_detections(detector, port, str(tmp_path / "port"), score_thresh=0.3,
                              label_map=label_map)
    jax_generate_model_detections(detector, jds, str(tmp_path / "jax"), score_thresh=0.3,
                                  label_map=label_map)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert len(want) == 6 and got == want


def test_compute_detection_map_equals_jax(root):
    port, jds = _datasets(root)
    det_dir = os.path.join(root, f"detections_{PART}")
    got = compute_detection_map(port, det_dir)
    want = jax_compute_detection_map(jds, det_dir)
    assert 0 < want["map"] <= 1
    for k in ("map", "mean_max_recall"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["ap"], want["ap"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["num_gt"], want["num_gt"])


def test_preprocess_detections_cli_equals_jax(tmp_path):
    root = str(tmp_path / "synth")
    make_synthetic_hicodet(root, PART, num_images=2, seed=4)
    ckpt = str(tmp_path / "frcnn.pt")
    torch.save({"model_state_dict": random_state_dict(WEIGHT_SEED)}, ckpt)
    common = ["--data-root", root, "--partition", PART, "--ckpt-path", ckpt, "--cpu",
              "--score-thresh", "0", "--min-size", "96", "--max-size", "160",
              "--canvas", "128", "192"]
    cache = preprocess_detections.main(common + ["--cache-dir", str(tmp_path / "port")])
    assert cache == str(tmp_path / "port" / PART)
    jax_preprocess.main(common + ["--cache-dir", str(tmp_path / "jax")])
    got, want = _files(tmp_path / "port" / PART), _files(tmp_path / "jax" / PART)
    assert got.keys() == want.keys() and len(want) == 2
    for name in want:
        g, w = json.loads(got[name]), json.loads(want[name])
        assert set(g) == {"boxes", "labels", "scores"} and len(w["boxes"]) == 100, name
        assert g["labels"] == w["labels"], name
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("detector", ["detr", "adamixer"])
def test_preprocess_detections_refuses_later_detectors(detector, tmp_path):
    """DETR and AdaMixer checkpoints run (``tests/test_torch_port_train_detector.py``
    holds their caches to the JAX tool's); without ``--cpu`` and without a
    card the tool refuses them, before it reads the checkpoint or writes."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    nowhere = str(tmp_path / "no-such-dir")
    with pytest.raises(RuntimeError, match="CUDA"):
        preprocess_detections.main(["--ckpt-path", nowhere + "/x.pt", "--detector", detector,
                                    "--data-root", nowhere, "--cache-dir", nowhere])
    assert not os.path.exists(nowhere)

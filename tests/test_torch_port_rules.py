"""Import and device rules of the port.

``skghoi_torch`` and ``chip_smoke.py`` import nothing of JAX, flax, the JAX
package or torchvision (checked on the source, by AST).  Entry points run on
CUDA unless the caller names the CPU: without a card they raise instead of
falling back, ``train_hicodet`` under torchrun's environment too.
"""

import ast
import os
from pathlib import Path

import pytest
import torch

from skghoi_torch.data.factory import to_device
from skghoi_torch.device import resolve_device
from skghoi_torch.entry import build_model, entry, make_batch, verb_mask
from skghoi_torch.models.backbone import DetectorBackbone
from skghoi_torch.models.scg import SpatiallyConditionedGraph
from skghoi_torch.ops.roi_align_cuda import roi_align_cuda
from skghoi_torch.detect.adamixer import AdaMixerDetector
from skghoi_torch.detect.detector import FPNDetector
from skghoi_torch.detect.detr import DETR
from skghoi_torch.detect.frcnn import FasterRCNN
from skghoi_torch.tools import (bench_io, cache_results, demo, extract_roi_features, perf_report,
                                preprocess_detections, pretrain_transh_hoi, stage_profile,
                                test_hicodet, train_detector, train_hicodet, train_kge,
                                visualise_detections)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "skghoi_tpu", "__graft_entry__", "bench",
             "torchvision")
SOURCES = sorted((ROOT / "skghoi_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
_NOWHERE = str(ROOT / "checkout_check" / "no-such-dir")  # the CLIs must raise before writing


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_sources_scanned():
    names = {p.name for p in SOURCES}
    assert {"roi_align_cuda.py", "scg.py", "weights.py", "chip_smoke.py", "factory.py",
            "engine.py", "checkpoint.py", "hoi_eval.py", "train_hicodet.py", "sampling.py",
            "trainer.py", "tester.py", "train_kge.py", "pretrain_transh_hoi.py",
            "vcoco_eval.py", "vcoco_evaluation.py", "distributed.py", "mesh.py", "frcnn.py",
            "generate.py", "eval_detections.py", "preprocess_detections.py", "hico_meta.py",
            "text_label.py", "logging.py", "profiling.py", "hicodet_split.py", "navigator.py",
            "generate_html_page.py", "learning_curve.py", "kge_results_table.py",
            "kge_relation_stats.py", "visualise_and_cache.py", "visualise_detections.py",
            "demo.py", "extract_roi_features.py", "bench_io.py", "perf_report.py",
            "stage_profile.py"} <= names
    assert ROOT / "skghoi_torch" / "utils" / "__init__.py" in SOURCES
    assert ROOT / "skghoi_torch" / "detect" / "__init__.py" in SOURCES


@pytest.mark.parametrize("build", [
    lambda: resolve_device(None),
    lambda: resolve_device("cuda"),
    lambda: SpatiallyConditionedGraph(),
    lambda: DetectorBackbone(),
    lambda: build_model(),
    lambda: make_batch(1, (64, 96)),
    lambda: verb_mask(),
    lambda: to_device(make_batch(1, (64, 96), device="cpu")),
    lambda: train_hicodet.main(["--synthetic", "--synthetic-root", _NOWHERE]),
    lambda: test_hicodet.main(["--synthetic", "--synthetic-root", _NOWHERE]),
    lambda: cache_results.main(["--dataset", "hicodet", "--synthetic", "--synthetic-root",
                                _NOWHERE]),
    lambda: train_kge.main(["--data", _NOWHERE, "--checkpoint", _NOWHERE + "/kge.pt"]),
    lambda: pretrain_transh_hoi.main(["--synthetic", "--output", _NOWHERE + "/transh.pt"]),
    lambda: FasterRCNN(),
    lambda: preprocess_detections.main(["--ckpt-path", _NOWHERE + "/frcnn.pt", "--data-root",
                                        _NOWHERE, "--cache-dir", _NOWHERE]),
    lambda: train_kge.main(["--data", _NOWHERE, "--data-parallel"]),
    lambda: FPNDetector(),
    lambda: AdaMixerDetector(),
    lambda: DETR(),
    lambda: train_detector.main(["--synthetic", "--synthetic-root", _NOWHERE, "--cache-dir",
                                 _NOWHERE]),
    lambda: demo.main(["--data-root", _NOWHERE, "--output", _NOWHERE + "/overlay.png"]),
    lambda: extract_roi_features.main(["--data-root", _NOWHERE, "--output-dir", _NOWHERE]),
    lambda: visualise_detections.main(["--data-root", _NOWHERE, "--detection-root", _NOWHERE,
                                       "--out-file", _NOWHERE + "/result.jpg"]),
    lambda: perf_report.report(1, (64, 96), trace_dir=_NOWHERE),
    lambda: stage_profile.profile(1, (64, 96)),
    lambda: bench_io.main(["--root", _NOWHERE, "--train"]),
], ids=["resolve", "resolve-cuda", "scg", "backbone", "build_model", "make_batch", "verb_mask",
        "to_device", "train_hicodet", "test_hicodet", "cache_results", "train_kge",
        "pretrain_transh_hoi", "frcnn", "preprocess_detections", "train_kge-data-parallel",
        "fpn_detector", "adamixer", "detr", "train_detector", "demo", "extract_roi_features",
        "visualise_detections", "perf_report", "stage_profile", "bench_io"])
def test_default_device_is_cuda(build):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    assert not os.path.exists(_NOWHERE)


def test_torchrun_train_hicodet_needs_a_card(monkeypatch):
    """Under torchrun's environment the process takes the card of its
    ``LOCAL_RANK``, and raises without one before it joins a group."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_hicodet.main(["--synthetic", "--synthetic-root", _NOWHERE])
    assert not os.path.exists(_NOWHERE) and not torch.distributed.is_initialized()


def test_kernel_wrapper_refuses_cpu():
    maps = [torch.zeros(1, 8 // s, 8 // s, 4) for s in (1, 2, 4, 8)]
    boxes = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_cuda(maps, boxes)


def test_cpu_on_request():
    assert resolve_device("cpu") == torch.device("cpu")
    fn, (batch,) = entry(device="cpu", dtype=torch.float32)
    assert batch.images.device.type == "cpu" and batch.images.shape == (1, 832, 1344, 3)
    scores = fn(batch)
    assert scores.shape == (1, 15, 30, 117) and torch.isfinite(scores).all()

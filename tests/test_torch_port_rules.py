"""Import and device rules of the port.

``skghoi_torch`` and ``chip_smoke.py`` import nothing of JAX, flax or the JAX
package (checked on the source, by AST).  Entry points run on CUDA unless
the caller names the CPU: without a card they raise instead of falling back.
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
from skghoi_torch.tools import (cache_results, pretrain_transh_hoi, test_hicodet, train_hicodet,
                                train_kge)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "skghoi_tpu", "__graft_entry__", "bench")
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
            "vcoco_eval.py", "vcoco_evaluation.py"} <= names


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
], ids=["resolve", "resolve-cuda", "scg", "backbone", "build_model", "make_batch", "verb_mask",
        "to_device", "train_hicodet", "test_hicodet", "cache_results", "train_kge",
        "pretrain_transh_hoi"])
def test_default_device_is_cuda(build):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    assert not os.path.exists(_NOWHERE)


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

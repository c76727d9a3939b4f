"""The port's measurement tools on the CPU, held to the JAX package's.

``perf_report.report`` (batch 1, 64x96): the JAX report's keys, with
``compile_seconds`` -> ``first_call_seconds``; ``mfu`` and the peak null off
a known card; the peak table keyed on the card's name.  The FLOP count of
the backbone + FPN forward against XLA's ``cost_analysis`` of the JAX
forward at the same shape.  ``stage_profile.profile``: every part runs at
batch 1, 64x96, with the JAX tool's keys, and ``n_params`` is the JAX SCG's
parameter count less the frozen-BN terms that the port keeps as buffers.
``bench_io --cpu --small``: the loader section's keys and image count equal
to the JAX tool's; ``--train`` runs two epochs of the port's engine, whose
log feeds ``learning_curve`` (``parse_log`` and stdout equal to JAX's).
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from skghoi_tpu.models import SpatiallyConditionedGraph as JaxSCG
from skghoi_tpu.models.backbone import DetectorBackbone as JaxBackbone
from skghoi_tpu.tools import bench_io as jax_bench_io
from skghoi_tpu.tools import learning_curve as jax_learning_curve
from skghoi_tpu.tools import perf_report as jax_perf_report
from skghoi_torch.entry import build_model
from skghoi_torch.models.backbone import DetectorBackbone
from skghoi_torch.models.resnet import FrozenBatchNorm
from skghoi_torch.tools import bench_io, learning_curve, perf_report, stage_profile

torch.set_num_threads(2)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed when the test ends, passed or failed:
    pytest keeps the directories of its last three runs, and a checkpoint of
    the full-width SCG is 675 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


CANVAS = (64, 96)


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs, a.choices)
            for a in parser._actions if a.dest != "help"}


def test_bench_io_same_flags_and_defaults():
    assert _flags(bench_io.build_argparser()) == _flags(jax_bench_io.build_argparser())


def test_perf_report_keys_match_jax():
    """The JAX report runs without its train section (compiling the JAX
    train step costs about a minute here); its train section has the same
    keys as its inference section (``perf_report.py:101-139``)."""
    got = perf_report.report(1, CANVAS, device="cpu")
    want = jax_perf_report.report(1, CANVAS, include_train=False)
    assert set(got) == set(want) | {"train", "flops_counted"}
    renamed = {"first_call_seconds" if k == "compile_seconds" else k for k in want["inference"]}
    assert set(got["inference"]) == renamed and set(got["train"]) == renamed
    assert got["device_kind"] == "cpu" and got["peak_bf16_flops"] is None
    assert (got["batch_size"], got["canvas"]) == (want["batch_size"], want["canvas"])
    for part in ("inference", "train"):
        sec = got[part]
        assert sec["mfu"] is None and sec["seconds_per_step"] > 0 and sec["images_per_sec"] > 0
    # A step is the forward, the backward (about twice the forward) and AdamW.
    ratio = got["train"]["tflops_per_step"] / got["inference"]["tflops_per_step"]
    assert 2.0 < ratio < 4.0, ratio


def test_peak_keyed_on_card_name(monkeypatch):
    cuda = torch.device("cuda")
    for name, peak in (("NVIDIA H100 80GB HBM3", 989.4e12), ("NVIDIA H100 PCIe", 756.5e12),
                       ("NVIDIA A100-SXM4-80GB", None), ("TPU v5 lite", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, n=name: n)
        assert perf_report.peak_for(cuda) == peak, name
    assert perf_report.peak_for(torch.device("cpu")) is None


def _xla_flops(module, x):
    variables = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    cost = jax.jit(module.apply).lower(variables, x).compile().cost_analysis()
    return float((cost[0] if isinstance(cost, list) else cost)["flops"])


@pytest.mark.parametrize("canvas, band", [
    # XLA leaves out the taps of a 3x3 convolution that fall on its padding;
    # at 64x96 (P5 is 2x3) they are 3.2% of the count (measured 1.0324).
    ((64, 96), (1.02, 1.045)),
    # At full size the padding is small, and XLA's elementwise work (frozen
    # BN, ReLU, residual and top-down adds) weighs more (measured 0.9804).
    ((832, 1344), (0.97, 0.99)),
], ids=["64x96", "832x1344"])
def test_backbone_flops_against_xla(canvas, band):
    """The port's count (``FlopCounterMode``, on the meta device: shapes
    only) against XLA's ``cost_analysis`` of the same bf16 forward with the
    ResNet blocks unrolled.  With JAX's default scanned blocks XLA counts
    each scan body once, and the count of the JAX tools falls to ~3/4."""
    x = jnp.zeros((1, *canvas, 3), jnp.float32)
    want = _xla_flops(JaxBackbone(dtype=jnp.bfloat16, scan_blocks=False), x)
    model = DetectorBackbone(dtype=torch.bfloat16, device="meta")
    with torch.no_grad():
        got = perf_report.count_flops(lambda: model(torch.zeros((1, *canvas, 3), device="meta")))
    assert band[0] < got / want < band[1], got / want
    scanned = _xla_flops(JaxBackbone(dtype=jnp.bfloat16), x)
    assert scanned / got < 0.8, scanned / got


def test_stage_profile_parts_and_params():
    got = stage_profile.profile(1, CANVAS, device="cpu", iters=1)
    stages = ("backbone_fpn", "stem", "layer1", "layer2", "layer3", "layer4")
    assert set(got) == {"batch", "canvas", "device_kind", *stages, "adamw_plain_ms",
                        "adamw_guarded_ms", "n_params", "n_params_updated", "roi_fwd_ms",
                        "roi_fwd_bwd_ms"}
    for name in stages:
        entry = got[name]
        assert set(entry) == {"fwd_ms", "fwd_tflops", "fwd_bwd_ms", "fwd_bwd_tflops"}
        assert all(v > 0 for v in entry.values()), (name, entry)
        assert entry["fwd_bwd_tflops"] > entry["fwd_tflops"], name
    assert sum(got[f"layer{i}"]["fwd_tflops"] for i in range(1, 5)) < got["backbone_fpn"]["fwd_tflops"]
    assert min(got[k] for k in ("adamw_plain_ms", "adamw_guarded_ms", "roi_fwd_ms",
                                "roi_fwd_bwd_ms")) > 0

    # JAX's stage_profile counts the leaves of the SCG's ``params`` at 64x96,
    # batch 1: they include the frozen BN's scale and bias, which the port
    # keeps as buffers with the statistics (``models/resnet.py``).
    ovm = graft._verb_mask()
    shapes = jax.eval_shape(lambda r, b: JaxSCG(dtype=jnp.bfloat16).init(r, b, ovm, training=True),
                            jax.random.PRNGKey(0), graft._make_batch(1, CANVAS, with_targets=True))
    jax_params = int(sum(np.prod(p.shape) for p in jax.tree_util.tree_leaves(shapes["params"])))
    model = build_model(device="cpu")
    bn_affine = sum(m.weight.numel() + m.bias.numel() for m in model.modules()
                    if isinstance(m, FrozenBatchNorm))
    assert got["n_params"] == sum(p.numel() for p in model.parameters())
    assert got["n_params"] + bn_affine == jax_params
    trained = sum(p.numel() for p in model.parameters() if p.requires_grad)
    assert got["n_params_updated"] == trained < got["n_params"]


def test_bench_io_and_learning_curve(tmp_path, capsys):
    root = str(tmp_path / "io")
    argv = ["--cpu", "--small", "--num-images", "4", "--batch-size", "2", "--num-workers", "2",
            "--epochs", "2", "--root", root]
    got = bench_io.main(argv + ["--train"])
    log = capsys.readouterr().out
    jax_bench_io.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got["loader"]) == set(want) and got["loader"]["num_images"] == want["num_images"] == 4
    assert [json.loads(line) for line in log.splitlines() if line.startswith("{")] == [
        got["loader"], got["train_e2e"]]
    assert got["loader"]["platform"] == "cpu" and got["train_e2e"]["imgs_per_s"] > 0
    assert set(got["train_e2e"]) == {
        "section", "platform", "num_images", "batch", "num_workers", "small", "epoch_imgs_per_s",
        "imgs_per_s", "first_epoch_seconds", "first_epoch_overhead_seconds"}

    resized = bench_io.main(["--cpu", "--small", "--device-resize", "--num-images", "4",
                             "--batch-size", "2", "--num-workers", "0", "--epochs", "1",
                             "--root", root])
    assert resized["loader"]["device_resize"] and resized["loader"]["num_images"] == 4
    capsys.readouterr()

    # The port engine's epoch lines, through both learning_curve tools.
    path = tmp_path / "train.log"
    path.write_text(log)
    parsed = learning_curve.parse_log(str(path))
    assert parsed == jax_learning_curve.parse_log(str(path)) and parsed[0] == [0, 1]
    out = str(tmp_path / "curve.png")
    texts = []
    for tool in (learning_curve, jax_learning_curve):
        tool.main([str(path), "--output", out])
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1] and f"Saved {out}" in texts[0]

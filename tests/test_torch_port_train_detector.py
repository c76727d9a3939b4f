"""The port's stage-1 detector tools on the CPU, held to what the JAX tools do.

- ``train_detector`` has the JAX tool's flags and defaults, and the same
  ``_first_occurrence_mask``;
- ``train_detector --synthetic --cpu`` for ``--arch fpn`` and ``--arch
  adamixer``: finite losses each step, a checkpoint an epoch, each loading
  strictly into a new model;
- the AdaMixer two-stage chain, as ``tests/test_cli_pipeline.py::
  test_adamixer_two_stage_chain`` runs the JAX tools: ``train_detector
  --arch adamixer`` -> ``preprocess_detections --detector adamixer`` ->
  ``train_hicodet`` on that cache, the cache files with the JAX tool's keys;
- ``preprocess_detections --detector adamixer`` (a JAX ``init`` carried over
  by ``weights.adamixer_state_dict``, against the JAX tool on its msgpack)
  and ``--detector detr`` (a facebookresearch-layout state dict, both tools
  on the same file): the same files, labels equal, boxes and scores within
  1e-4;
- data parallel over two gloo ranks: the FPN step and the AdaMixer step
  (shared assignments) on each rank's half of a batch of 4 equal the
  one-process step on the whole batch (losses at rtol 2e-4, every gradient
  within 1e-3 of its tensor's largest; four of AdaMixer's backbone tensors
  against the whole batch in float64, see ``BATCH_SEED``), so the positive
  and GT counts that normalise the losses are global;
- ``train_detector.adamw`` against optax ``adamw`` on the same gradients
  (1e-6 of each parameter's largest), and two AdaMixer steps of the tool's
  step from one JAX ``init`` against JAX ``train_adamixer``'s step on the
  same batch and assignments (the losses at rtol 1e-4);
- the detectors and the tool default to the card and raise without one.
"""

import glob
import json
import os
import shutil
from unittest import mock

import numpy as np
import pytest
import torch
from flax import serialization

from skghoi_tpu.data.synthetic import make_synthetic_hicodet
from skghoi_tpu.tools import preprocess_detections as jax_preprocess
from skghoi_tpu.tools import train_detector as jax_train_detector
from skghoi_torch.detect import adamixer
from skghoi_torch.detect.adamixer import AdaMixerDetector
from skghoi_torch.detect.detector import FPNDetector
from skghoi_torch.detect.detr import DETR
from skghoi_torch.parallel.mesh import shard_batch
from skghoi_torch.tools import preprocess_detections, train_detector, train_hicodet
from skghoi_torch.train.checkpoint import load_checkpoint
from test_detr import synth_detr_state_dict
from test_torch_port_ddp import _run_ranks

torch.set_num_threads(2)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed when the test ends, passed or failed:
    pytest keeps the directories of its last three runs, and the detectors' and
    the SCG's checkpoints written here are hundreds of MB each."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


TINY = ["--num-queries", "12", "--num-stages", "2", "--content-dim", "64", "--groups", "4",
        "--in-points", "8", "--out-points", "16", "--ffn-dim", "128"]
TINY_CFG = dict(num_queries=12, num_stages=2, content_dim=64, groups=4, in_points=8,
                out_points=16, ffn_dim=128)
ENVELOPE = ["--min-size", "64", "--max-size", "96", "--canvas", "64", "96"]
_NOWHERE = os.path.join(os.path.dirname(__file__), "..", "checkout_check", "no-such-dir")


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs, a.choices)
            for a in parser._actions if a.dest != "help"}


def test_same_flags_and_defaults():
    """The JAX tool's flags and defaults, and one of the port's own:
    ``--frozen-stages``, whose default -1 trains every stage as the JAX tool does."""
    port = _flags(train_detector.build_argparser())
    assert port.pop("frozen_stages") == (("--frozen-stages",), -1, int, None, None)
    assert port == _flags(jax_train_detector.build_argparser())


def test_first_occurrence_mask_equals_jax():
    rng = np.random.default_rng(0)
    boxes = np.round(rng.uniform(0, 50, (3, 10, 4)), 2).astype(np.float32)
    boxes[:, 5:] = boxes[:, :5] + rng.uniform(-0.04, 0.04, (3, 5, 4)).astype(np.float32)
    labels = rng.integers(0, 3, (3, 10))
    labels[:, 5:] = labels[:, :5]
    valid = rng.uniform(size=(3, 10)) > 0.2
    got = train_detector._first_occurrence_mask(boxes, labels, valid)
    np.testing.assert_array_equal(got, jax_train_detector._first_occurrence_mask(
        boxes, labels, valid))
    assert got.sum() < valid.sum()


def _finite_losses(result, key):
    losses = [step[k] for step in result["losses"] for k in step]
    assert losses and all(np.isfinite(losses)) and all(key in step for step in result["losses"])


def test_train_detector_fpn_cli(tmp_path, capsys):
    result = train_detector.main(["--synthetic", "--cpu", "--synthetic-root", str(tmp_path / "s"),
                                  "--cache-dir", str(tmp_path / "ck"), "--num-epochs", "2"])
    out = capsys.readouterr().out
    assert "iter 1: cls " in out and "Detector training complete." in out
    _finite_losses(result, "box_loss")
    assert len(result["losses"]) == 4  # 8 landscape images, batch 4, 2 epochs
    assert sorted(os.listdir(tmp_path / "ck")) == ["det_00.pt", "det_01.pt"]
    ckpt = load_checkpoint(str(tmp_path / "ck" / "det_01.pt"))
    assert ckpt["epoch"] == 1 and ckpt["iteration"] == 4
    model = FPNDetector(device="cpu")
    model.load_state_dict(ckpt["model_state_dict"], strict=True)
    for name, p in result["model"].state_dict().items():
        assert torch.equal(model.state_dict()[name], p), name


def test_adamixer_two_stage_chain(tmp_path, capsys):
    root, det_ckpts = str(tmp_path / "synth"), str(tmp_path / "det_ckpts")
    result = train_detector.main(["--synthetic", "--cpu", "--synthetic-root", root, "--arch",
                                  "adamixer", "--cache-dir", det_ckpts, "--batch-size", "2",
                                  "--num-epochs", "1", *TINY])
    out = capsys.readouterr().out
    assert "set_loss" in out and "Detector training complete." in out
    _finite_losses(result, "set_loss")
    ckpt = os.path.join(det_ckpts, "adamixer_00.pt")
    blob = torch.load(ckpt, weights_only=True)
    assert blob["config"] == dict(num_classes=80, **TINY_CFG)
    AdaMixerDetector(device="cpu", **blob["config"]).load_state_dict(blob["state_dict"],
                                                                     strict=True)

    cache = preprocess_detections.main([
        "--partition", "train2015", "--data-root", root, "--cache-dir", str(tmp_path / "dets"),
        "--ckpt-path", ckpt, "--detector", "adamixer", "--score-thresh", "0.05", "--cpu",
        *ENVELOPE])
    assert "Cached" in capsys.readouterr().out
    files = sorted(glob.glob(os.path.join(cache, "*.json")))
    assert len(files) == 8, files
    for f in files:
        with open(f) as fh:
            det = json.load(fh)
        assert set(det) == {"boxes", "labels", "scores"}
        assert len(det["boxes"]) == len(det["labels"]) == len(det["scores"]) > 0

    engine = train_hicodet.main(["--synthetic", "--cpu", "--synthetic-root", root, "--cache-dir",
                                 str(tmp_path / "hoi"), "--train-detection-dir", cache,
                                 "--batch-size", "1", "--num-workers", "0"])
    out = capsys.readouterr().out
    assert "Epoch" in out and "Training complete." in out and engine.iteration > 0
    assert glob.glob(str(tmp_path / "hoi" / "ckpt_*"))


def _jsons(d):
    out = {}
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            out[os.path.basename(f)] = json.load(fh)
    return out


def _same_caches(got_dir, want_dir, min_boxes):
    got, want = _jsons(got_dir), _jsons(want_dir)
    assert got.keys() == want.keys() and len(want) == 2
    for name in want:
        g, w = got[name], want[name]
        assert set(g) == set(w) == {"boxes", "labels", "scores"} and len(w["boxes"]) >= min_boxes
        assert g["labels"] == w["labels"], name
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-4, atol=1e-4, err_msg=name)


def test_preprocess_adamixer_equals_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from skghoi_tpu.detect.adamixer import AdaMixerDetector as JaxAdaMixer
    from skghoi_torch.weights import adamixer_state_dict

    root = str(tmp_path / "synth")
    make_synthetic_hicodet(root, "train2015", num_images=2, seed=4)
    cfg = dict(num_classes=80, **TINY_CFG)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(JaxAdaMixer(**cfg).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 96, 3))))
    with open(tmp_path / "a.msgpack", "wb") as f:
        f.write(serialization.msgpack_serialize(
            {"config": cfg, "params": variables["params"],
             "extra": {k: v for k, v in variables.items() if k != "params"}}))
    torch.save({"config": cfg, "state_dict": adamixer_state_dict(variables)}, tmp_path / "a.pt")
    common = ["--data-root", root, "--partition", "train2015", "--detector", "adamixer",
              "--score-thresh", "0", *ENVELOPE]
    preprocess_detections.main(common + ["--ckpt-path", str(tmp_path / "a.pt"), "--cpu",
                                         "--cache-dir", str(tmp_path / "port")])
    jax_preprocess.main(common + ["--ckpt-path", str(tmp_path / "a.msgpack"),
                                  "--cache-dir", str(tmp_path / "jax")])
    _same_caches(tmp_path / "port" / "train2015", tmp_path / "jax" / "train2015", 12)


def test_preprocess_detr_equals_jax(tmp_path):
    root = str(tmp_path / "synth")
    make_synthetic_hicodet(root, "train2015", num_images=2, seed=4)
    ckpt = str(tmp_path / "detr.pt")
    torch.save({"model_state_dict": synth_detr_state_dict(np.random.default_rng(9))}, ckpt)
    common = ["--data-root", root, "--partition", "train2015", "--ckpt-path", ckpt,
              "--detector", "detr", "--score-thresh", "0", "--min-size", "96", "--max-size",
              "160", "--canvas", "128", "192"]
    preprocess_detections.main(common + ["--cpu", "--cache-dir", str(tmp_path / "port")])
    jax_preprocess.main(common + ["--cache-dir", str(tmp_path / "jax")])
    _same_caches(tmp_path / "port" / "train2015", tmp_path / "jax" / "train2015", 100)


# --- data parallel ------------------------------------------------------------------

CANVAS = (64, 96)
# Image seed 5 puts a ReLU input of the FPN's layer4 within float32 rounding
# of 0: one rank's half batch (one thread) and the whole batch round it to
# opposite sides, which moves layer4.2.conv3's gradient by 1.2% of its
# largest (as at tests/test_torch_port_ddp.py::INIT_SEED).
BATCH_SEED = 6
# AdaMixer's backbone gradients in float32 at this batch: the whole-batch
# step (two threads) is up to 8.1e-3 of the largest from a float64 run in
# layer3.1.conv2 (1.7e-3 in layer3.1.conv1, 1.0e-3 in layer1.{0,1}.conv2),
# while each rank's half-batch step is within 2.8e-6 of it; there the ranks'
# gradients are held against the float64 whole-batch step.  (The decoder's
# cannot be: float64 moves its offset generators' gradients by 35-54% of
# their largest, and those of the ranks and the whole batch agree.)


def _det_batch():
    """4 images with 3 GT slots each, counts differing between the halves."""
    rng = np.random.default_rng(BATCH_SEED)
    images = torch.from_numpy(rng.uniform(0, 1, (4, *CANVAS, 3)).astype(np.float32))
    xy = rng.uniform(0, 50, (4, 3, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(12, 40, (4, 3, 2))], -1)
                             .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 80, (4, 3)))
    valid = torch.tensor([[1, 1, 1], [1, 0, 0], [1, 1, 0], [1, 0, 0]], dtype=torch.bool)
    return images, boxes, labels, valid


def _sgd(model):
    return torch.optim.SGD(model.parameters(), lr=1e-2)


def _step(arch, data_parallel, assignments=None):
    """One training step on the (sharded) batch -> losses and gradients.
    AdaMixer's step matches on ``assignments`` ``[S, B, G]`` when given
    (sharded like the batch), else on its own, which it returns."""
    images, boxes, labels, valid = _det_batch()
    batch = (images, boxes, labels, valid)
    if data_parallel:
        batch = tuple(map(shard_batch, batch))
        if assignments is not None:
            assignments = shard_batch(torch.from_numpy(assignments).transpose(0, 1)
                                      ).transpose(0, 1).numpy()
    if arch == "fpn":
        model = FPNDetector(device="cpu")
        losses = train_detector.build_fpn_step(model, _sgd(model))(*batch)
    else:
        model = AdaMixerDetector(device="cpu", **TINY_CFG)
        own = adamixer.compute_assignments

        def shared(*args):
            nonlocal assignments
            if assignments is None:
                assignments = own(*args)
            return assignments

        with mock.patch.object(adamixer, "compute_assignments", shared):
            losses = train_detector.build_adamixer_step(model, _sgd(model))(*batch)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return dict(losses={k: v.item() for k, v in losses.items()}, grads=grads,
                assignments=assignments)


def _adamixer_float64_grads(assignments):
    """The whole batch's AdaMixer gradients in float64, on ``assignments``."""
    images, boxes, labels, valid = _det_batch()
    model = AdaMixerDetector(device="cpu", **TINY_CFG).double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    model.mean, model.std = model.mean.double(), model.std.double()
    adamixer.set_loss(model(images.double()), torch.from_numpy(assignments), boxes.double(),
                      labels, valid, (float(CANVAS[0]), float(CANVAS[1])))["set_loss"].backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["fpn", "adamixer"])
def test_data_parallel_step_equals_whole_batch(tmp_path, arch):
    want = _step(arch, False)
    ranks = _run_ranks(tmp_path, _step, arch, True, want["assignments"])
    exact = _adamixer_float64_grads(want["assignments"]) if arch == "adamixer" else None
    for r, got in enumerate(ranks):
        for k, v in want["losses"].items():
            assert v > 0
            np.testing.assert_allclose(got["losses"][k], v, rtol=2e-4, err_msg=f"rank {r} {k}")
        for name, g in want["grads"].items():
            # The attention's key bias has an exact gradient of 0 (it shifts a
            # softmax row alike): held at the key weight's scale.
            scale = want["grads"][name.replace("key.bias", "key.weight")].abs().max().item()
            err = (got["grads"][name] - g).abs().max().item()
            if err <= 1e-3 * max(scale, 1e-12):
                continue
            # Where the whole-batch float32 step is itself off (see BATCH_SEED),
            # the rank is held against the float64 one.
            assert exact is not None and name.startswith("backbone."), (r, name, err, scale)
            err = (got["grads"][name].double() - exact[name]).abs().max().item()
            assert err <= 1e-3 * exact[name].abs().max().item(), (r, name, "float64", err)


def test_adamw_equals_optax():
    """``train_detector.adamw`` is optax ``adamw``: three updates on the same
    gradients, at a weight decay large enough to show, within 1e-6 of each
    parameter's largest."""
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(3)
    init = [rng.standard_normal(shape).astype(np.float32) for shape in ((7, 5), (5,), (3, 2, 4))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in init] for _ in range(3)]
    tx = optax.adamw(1e-2, weight_decay=0.5)
    params = [jnp.asarray(p) for p in init]
    state = tx.init(params)
    module = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init])
    opt = train_detector.adamw(module, 1e-2, 0.5)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, updates)
        for p, x in zip(module, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    for got, want, start in zip(module, params, init):
        want = np.asarray(want)
        assert np.abs(want - start).max() > 1e-2
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_adamixer_adamw_steps_equal_jax():
    """Two steps of ``train_detector``'s AdaMixer step and AdamW from one JAX
    ``init`` (lr 1e-4, weight decay 1e-4, the tool's defaults) against JAX
    ``train_adamixer``'s step on the same batch and assignments: each loss at
    rtol 1e-4, so the second holds the first update (measured 9.4e-8 and
    4.2e-5).  A third step is float32 noise that Adam's normalised update
    spreads over every near-zero gradient: the port against itself on one
    thread and on two already differs by 1.1e-4 there, and against JAX by
    4.1e-4."""
    import jax
    import jax.numpy as jnp
    import optax

    from skghoi_tpu.detect import adamixer as J
    from skghoi_torch.weights import adamixer_state_dict

    images, boxes, labels, valid = _det_batch()
    hw = (float(CANVAS[0]), float(CANVAS[1]))
    model = J.AdaMixerDetector(num_classes=80, **TINY_CFG)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(images.numpy())))
    params, extra = variables["params"], {k: v for k, v in variables.items() if k != "params"}
    tx = optax.adamw(1e-4, weight_decay=1e-4)
    opt_state = tx.init(params)
    jargs = tuple(jnp.asarray(t.numpy()) for t in (images, boxes, labels, valid))

    @jax.jit
    def jax_step(params, opt_state, assignments):  # train_adamixer's step
        def loss_fn(p):
            out = model.apply({"params": p, **extra}, jargs[0])
            return J.set_loss(out, assignments, *jargs[1:], hw)["set_loss"]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    want, shared = [], []
    for _ in range(2):
        out = model.apply({"params": params, **extra}, jargs[0])
        shared.append(J.compute_assignments(out, *jargs[1:], hw))
        params, opt_state, loss = jax_step(params, opt_state, jnp.asarray(shared[-1]))
        want.append(float(loss))

    port = AdaMixerDetector(device="cpu", **TINY_CFG)
    port.load_state_dict(adamixer_state_dict(variables), strict=True)
    step = train_detector.build_adamixer_step(port, train_detector.adamw(port, 1e-4, 1e-4))
    queue = iter(shared)
    with mock.patch.object(adamixer, "compute_assignments", lambda *args: next(queue)):
        got = [step(images, boxes, labels, valid)["set_loss"].item() for _ in range(2)]
    assert want[1] != want[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("build", [
    lambda: FPNDetector(),
    lambda: AdaMixerDetector(**TINY_CFG),
    lambda: DETR(num_layers=1),
    lambda: train_detector.main(["--synthetic", "--synthetic-root", _NOWHERE]),
    lambda: train_detector.main(["--synthetic", "--arch", "adamixer", "--synthetic-root",
                                 _NOWHERE]),
], ids=["fpn", "adamixer", "detr", "train_detector-fpn", "train_detector-adamixer"])
def test_default_device_is_cuda(build):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    assert not os.path.exists(_NOWHERE)

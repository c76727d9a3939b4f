"""The port's learning engine held against the JAX package's, on the CPU.

One epoch of 2 iterations (4 synthetic images at 64x96, random flips,
shuffled, batch 2) through the port's ``LearningEngine`` and through JAX's
``LearningEngine(use_mesh=False)``, with the same weights (the JAX
initialisation carried over by ``to_state_dict``) and the JAX engine's
Gumbel noise replayed into the port's: the losses of each iteration within
rtol 1e-4, every parameter after the epoch within 1e-3 of its tensor's
largest magnitude plus a tenth of an AdamW step (all but at most one
element in a thousand: see the test), and the epoch's training mAP within
1e-4.  Then the port's checkpoint round trip, as
``tests/test_engine_resume.py`` does it for JAX, with the optimizer state
bit for bit; frozen parameters never change.  The JAX train step is
compiled once for the file.
"""

import contextlib
import io
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skghoi_tpu.data.factory import DataFactory as JaxDataFactory
from skghoi_tpu.data.factory import HOILoader as JaxHOILoader
from skghoi_tpu.data.synthetic import make_synthetic_hicodet
from skghoi_tpu.models import SpatiallyConditionedGraph as JaxSCG
from skghoi_tpu.train.engine import LearningEngine as JaxEngine
from skghoi_torch.data.factory import DataFactory, HOILoader
from skghoi_torch.entry import build_model
from skghoi_tpu.models.backbone import convert_resnet_block_layout
from skghoi_torch.train.checkpoint import load_checkpoint, load_model_state
from skghoi_torch.train.engine import LearningEngine
from skghoi_torch.weights import to_state_dict

torch.set_num_threads(2)

SMALL = dict(min_size=64, max_size=107, canvas_landscape=(64, 96), canvas_portrait=(96, 64))
INIT_KEY = 6  # the weights of tests/test_torch_port_train.py (no ReLU flip at this size)
ENGINE_SEED = 3
NOISE_SHAPE = (2, 15 * 30 * 117)
LR, LR_DECAY = 1e-4, 0.1  # both engines' defaults: head lr, detector multiplier


def _record(engine, losses, maps):
    """Wrap the engine's train step and end of epoch to record each
    iteration's losses and the epoch's training mAP."""
    step, end = engine.train_step, engine._on_end_epoch

    def train_step(*args, **kwargs):
        out = step(*args, **kwargs)
        losses.append({k: float(v) for k, v in out[3 if len(args) > 1 else 1].items()})
        return out

    def on_end_epoch(meter):
        maps.append(float(meter.eval().mean()))
        end(meter)

    engine.train_step, engine._on_end_epoch = train_step, on_end_epoch


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed when the test ends, passed or failed:
    pytest keeps the directories of its last three runs, and a checkpoint of
    the full-width SCG is 675 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The epoch through both engines; its data and both engines'
    checkpoints (``ckpt_02.pt`` from the resume test too) are removed when
    the module ends."""
    root = str(tmp_path_factory.mktemp("engine_synth"))
    cache = tmp_path_factory.mktemp("engine_ckpts")
    try:
        yield _run(root, cache)
    finally:
        for d in (root, cache):
            shutil.rmtree(d, ignore_errors=True)


def _run(root, cache):
    make_synthetic_hicodet(root, "train2015", num_images=4, seed=0)
    det = os.path.join(root, "detections_train2015")
    jf = JaxDataFactory("hicodet", "train2015", root, det, flip=True, seed=1, **SMALL)
    pf = DataFactory("hicodet", "train2015", root, det, flip=True, seed=1, **SMALL)
    jloader = JaxHOILoader(jf, 2, shuffle=True, with_targets=True, seed=1)
    ploader = HOILoader(pf, 2, shuffle=True, with_targets=True, seed=1)
    ovm = jf.dataset.object_verb_mask()
    first, _ = next(iter(jloader))
    model = JaxSCG()
    variables = jax.jit(lambda r, b: model.init(r, b, jnp.asarray(ovm), training=False))(
        jax.random.PRNGKey(INIT_KEY), first)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    initial = to_state_dict(variables)

    jengine = JaxEngine(model, variables, jloader, None, object_verb_mask=ovm, print_interval=1,
                        cache_dir=str(cache / "jax"), seed=ENGINE_SEED, use_mesh=False)
    want = dict(losses=[], maps=[])
    _record(jengine, want["losses"], want["maps"])

    noise = {"rng": jax.random.PRNGKey(ENGINE_SEED)}

    def gumbel():  # the JAX engine's draws: split per iteration, gumbel of the step key
        noise["rng"], step_rng = jax.random.split(noise["rng"])
        return torch.from_numpy(np.array(jax.random.gumbel(step_rng, NOISE_SHAPE)))

    port = build_model(device="cpu")
    port.load_state_dict(initial, strict=True)
    engine = LearningEngine(port, ploader, None, object_verb_mask=ovm, print_interval=1,
                            cache_dir=str(cache / "port"), seed=ENGINE_SEED, gumbel=gumbel)
    got = dict(losses=[], maps=[])
    _record(engine, got["losses"], got["maps"])

    for eng, rec in ((jengine, want), (engine, got)):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            eng.run(1)
        rec["log"] = text.getvalue()
    want["params"] = to_state_dict({"params": jengine.params, **jengine.extra_vars})
    return dict(want=want, got=got, engine=engine, initial=initial, ovm=ovm, loader=ploader,
                cache=str(cache / "port"), variables=variables)


def test_losses_match_each_iteration(run):
    want, got = run["want"]["losses"], run["got"]["losses"]
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k, v in w.items():
            assert v > 0, f"iteration {i}: {k} is 0, the comparison would be vacuous"
            np.testing.assert_allclose(g[k], v, rtol=1e-4, err_msg=f"iteration {i} {k}")


def test_parameters_after_the_epoch_match(run):
    """AdamW scales each element's step to about the learning rate whatever
    its gradient's size, so an element whose gradient sits at float32
    rounding level (within the train-step tests' 1e-3 of the tensor's
    largest gradient) takes a step of any sign and size in either package.
    Each element is held to 1e-3 of its tensor's largest magnitude plus a
    tenth of one step; at most one element in a thousand of a tensor may lie
    beyond (measured: at most 1.7e-4 of a tensor, 1.7 steps apart).  The
    adjacency bias, whose exact gradient is 0 (it shifts both softmaxes
    alike), is held at the adjacency weight's scale."""
    want, model = run["want"]["params"], run["engine"].model
    state = model.state_dict()
    assert state.keys() == want.keys()
    moved = 0
    for name, p in model.named_parameters():
        w, got = want[name].numpy(), p.detach().numpy()
        if not p.requires_grad:
            np.testing.assert_array_equal(got, w, err_msg=name)
            continue
        lr = LR * (LR_DECAY if name.startswith("detector.") else 1.0)
        scale = np.abs(want[name.replace("adjacency.bias", "adjacency.weight")].numpy()).max()
        beyond = np.abs(got - w) > 1e-3 * scale + 0.1 * lr
        assert beyond.mean() <= 1e-3, (name, int(beyond.sum()), w.size)
        moved += not torch.equal(p.detach(), run["initial"][name])
    assert moved > 100
    for name, b in model.named_buffers():  # frozen BN statistics
        np.testing.assert_array_equal(b.numpy(), want[name].numpy(), err_msg=name)


def test_epoch_line_and_training_map_match(run):
    want, got = run["want"], run["got"]
    assert len(got["maps"]) == len(want["maps"]) == 1
    assert want["maps"][0] > 0, "a zero training mAP would make the comparison vacuous"
    np.testing.assert_allclose(got["maps"][0], want["maps"][0], rtol=0, atol=1e-4)
    for rec in (want, got):
        epoch = [line for line in rec["log"].splitlines() if line.startswith("Epoch: ")]
        assert len(epoch) == 1 and epoch[0].startswith("Epoch: 0 | training mAP: ")
        assert rec["log"].count("=> HOI classification loss: ") == 2
    assert len(got["log"].splitlines()) == len(want["log"].splitlines())


def test_frozen_parameters_never_change(run):
    model = run["engine"].model
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(n.startswith(("detector.backbone.conv1.", "detector.backbone.layer1."))
                          for n in frozen)
    for name in frozen:
        assert torch.equal(dict(model.named_parameters())[name], run["initial"][name]), name
    groups = run["engine"].optimizer.param_groups
    in_groups = {id(p) for g in groups for p in g["params"]}
    assert not any(id(p) in in_groups for n, p in model.named_parameters() if n in frozen)


def _state_equal(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _state_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _state_equal(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def test_resume_roundtrip(run):
    engine, cache = run["engine"], run["cache"]
    path = os.path.join(cache, "ckpt_01.pt")
    ckpt = load_checkpoint(path)
    assert set(ckpt) == {"model_state_dict", "optim_state_dict", "scheduler_state_dict",
                         "epoch", "iteration"}
    assert ckpt["epoch"] == 1 and ckpt["iteration"] == 2
    assert ckpt["scheduler_state_dict"] == {"step": 2}

    fresh = build_model(device="cpu", seed=11)
    engine2 = LearningEngine(fresh, run["loader"], None, object_verb_mask=run["ovm"],
                             print_interval=1000, cache_dir=cache, seed=ENGINE_SEED)
    engine2.resume(path)
    assert engine2.epoch == 1 and engine2.iteration == engine.iteration == 2
    _state_equal(fresh.state_dict(), engine.model.state_dict())
    _state_equal(engine2.optimizer.state_dict(), engine.optimizer.state_dict())
    assert [g["applied_steps"] for g in engine2.optimizer.param_groups] == [2, 2]
    assert [g["lr"] for g in engine2.optimizer.param_groups] == [1e-5, 1e-4]

    with contextlib.redirect_stdout(io.StringIO()):
        engine2.run(1)  # training continues from the restored state
    assert engine2.epoch == 2 and engine2.iteration == 4
    assert os.path.exists(os.path.join(cache, "ckpt_02.pt"))
    assert [g["applied_steps"] for g in engine2.optimizer.param_groups] == [4, 4]


@pytest.mark.parametrize("scanned", [True, False], ids=["scanned", "unrolled"])
def test_checkpoint_of_a_jax_tree_loads_converted(run, tmp_path, scanned):
    """A checkpoint whose weights are a JAX variable tree, in either ResNet
    layout, loads through ``load_model_state`` (what ``resume`` and the
    evaluation tools call) into the same port weights as ``to_state_dict``."""
    tree = convert_resnet_block_layout(run["variables"], to_scan=scanned)
    tree = jax.tree_util.tree_map(lambda x: torch.tensor(np.array(x)), tree)
    path = str(tmp_path / "jax_tree.pt")
    torch.save({"model_state_dict": tree}, path)
    model = build_model(device="cpu", seed=5)
    load_model_state(model, load_checkpoint(path)["model_state_dict"])
    _state_equal(model.state_dict(), run["initial"])

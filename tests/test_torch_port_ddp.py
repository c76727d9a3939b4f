"""Data-parallel training over ``torch.distributed``, two gloo ranks on the CPU.

The one-process port step already equals JAX's ``build_train_step``
(``tests/test_torch_port_train.py``), so the data-parallel step is held
against the one-process step on the whole batch:

- The SCG train step at full width, 64x96, a global batch of 4 split over two
  ranks (``parallel.mesh.shard_batch``), with the same numpy Gumbel noise
  (each rank its rows): each rank's reported losses equal the one-process
  losses at rtol 2e-4 (``tests/test_multichip.py``'s bound for the sharded
  JAX step); each rank's averaged gradients equal the one-process gradients
  within 1e-3 of each tensor's largest (``test_torch_port_train``'s bound);
  after an SGD step the parameters are bit for bit the same on both ranks and
  within 1e-3 of each tensor's largest of the one-process step's.  SGD makes
  the parameter change proportional to the averaged gradient; AdamW's first
  step would scale each element to +-lr and so magnify rounding-level
  gradients (``ROADMAP.md``, Queue 3).
- The NaN guard: a NaN image on rank 1 skips the AdamW update on both ranks.
- The engine over two ranks on 5 synthetic images (batch 2: shards of 3 and
  2 images, so 2 and 1 batches): both ranks run 2 steps (rank 1 takes its
  batch again), report the same averaged losses and end with the same
  parameters bit for bit; only rank 0 prints the ``Epoch:`` line and writes
  the checkpoint.
- The KGE ``Trainer`` under a process group (``train_kge --data-parallel``): each rank
  fed its half of numpy-drawn batches equals the one-process trainer on the
  whole batches over three Adam steps, parameters within 1e-5 of each
  tensor's largest and losses at rtol 1e-6.

Each multi-process test waits at most ``RANK_TIMEOUT`` seconds for its ranks,
then kills them and fails, so a hung rendezvous cannot eat the suite's time.
The rendezvous is a ``file://`` in the test's own directory (no TCP port).
"""

import contextlib
import io
import multiprocessing as mp
import shutil
import time

import numpy as np
import pytest
import torch

from skghoi_torch.data.factory import DataFactory, HOILoader
from skghoi_torch.data.synthetic import make_synthetic_hicodet
from skghoi_torch.entry import build_model, make_batch, verb_mask
from skghoi_torch.kge import KGData, NegativeSampling, SoftplusLoss, Trainer, models
from skghoi_torch.kge.sampling import DeviceKG, TripleBatch
from skghoi_torch.parallel import distributed
from skghoi_torch.parallel.mesh import shard_batch
from skghoi_torch.parallel.train_step import build_train_step
from skghoi_torch.train.engine import LearningEngine
from skghoi_torch.train.optimizer import build_optimizer

torch.set_num_threads(2)

CANVAS = (64, 96)
GLOBAL_BATCH, WORLD = 4, 2
RANK_TIMEOUT = 420
SGD_LR = 1e-2
# Weights with no ReLU input within float32 rounding of 0 at this batch: the
# two ranks' half batches and the whole batch round differently (other GEMM
# and conv blockings), and at seeds 0-2 one MBF ReLU input flips sides, which
# moves that branch's gradient by 1e-3-6e-3 of its tensor's max (as at
# tests/test_torch_port_train.py::INIT_KEY).
INIT_SEED = 3
GUMBEL_COLS = 15 * 30 * 117


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed when the test ends, passed or failed:
    pytest keeps the directories of its last three runs, and a checkpoint of
    the full-width SCG is 675 MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _run_ranks(tmp_path, target, *args):
    """``target(*args)`` in ``WORLD`` spawned gloo ranks; their results."""
    ctx = mp.get_context("spawn")
    init = f"file://{tmp_path}/rendezvous"
    procs = [ctx.Process(target=_rank_main, args=(target, r, init, str(tmp_path), *args))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f"{len(hung)} rank(s) still running after {RANK_TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _rank_main(target, rank, init, out_dir, *args):
    torch.set_num_threads(1)
    distributed.initialize("cpu", init_method=init, rank=rank, world_size=WORLD)
    try:
        torch.save(target(*args), f"{out_dir}/rank{rank}.pt")
    finally:
        distributed.shutdown()


# --- the SCG train step ---------------------------------------------------------

def _gumbel():
    return torch.from_numpy(
        np.random.default_rng(11).gumbel(size=(GLOBAL_BATCH, GUMBEL_COLS)).astype(np.float32))


def _hoi_step(batch, gumbel, optimizer_fn):
    """One train step of the seeded full-width SCG on ``batch``; the model too."""
    model = build_model(device="cpu", seed=INIT_SEED)
    step = build_train_step(model, optimizer_fn(model), verb_mask(device="cpu"))
    total, losses, _, applied = step(batch, gumbel=gumbel)
    return model, dict(total=float(total), applied=applied,
                       losses={k: float(v) for k, v in losses.items()})


def _sgd(model):
    return torch.optim.SGD([p for p in model.parameters() if p.requires_grad], lr=SGD_LR)


def _trained(model):
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _hoi_rank(reference_path):
    """Rank side: the data-parallel SGD step, checked against the
    one-process step's gradients and parameters; then an AdamW step with a
    NaN image on rank 1."""
    rank = distributed.rank()
    batch, gumbel = make_batch(GLOBAL_BATCH, CANVAS, with_targets=True, device="cpu"), _gumbel()
    model, out = _hoi_step(shard_batch(batch), shard_batch(gumbel), _sgd)
    ref = torch.load(reference_path, weights_only=True)
    grad_err, param_err, same = {}, {}, True
    for name, p in _trained(model).items():
        # The adjacency bias shifts every logit of both softmaxes alike, so its
        # exact gradient is 0: it is held at the adjacency weight's scale.
        scale_name = name.replace("adjacency.bias", "adjacency.weight")
        g_scale = ref["grads"][scale_name].abs().max().item()
        p_scale = ref["params"][scale_name].abs().max().item()
        grad_err[name] = ((p.grad - ref["grads"][name]).abs().max().item(), g_scale)
        param_err[name] = ((p.detach() - ref["params"][name]).abs().max().item(), p_scale)
        other = p.detach().clone()
        torch.distributed.broadcast(other, 0)
        same &= torch.equal(other, p.detach())
    out.update(grad_err=grad_err, param_err=param_err, same_across_ranks=same)

    # The NaN guard, with the engine's optimizer.
    nan_batch = shard_batch(batch)
    if rank == 1:
        nan_batch.images[0, 0, 0, 0] = float("nan")
    model = build_model(device="cpu", seed=INIT_SEED)
    before = {n: p.detach().clone() for n, p in _trained(model).items()}
    optimizer = build_optimizer(model)
    step = build_train_step(model, optimizer, verb_mask(device="cpu"))
    total, _, _, applied = step(nan_batch, gumbel=shard_batch(gumbel))
    out["nan"] = dict(applied=applied, total=float(total),
                      unchanged=all(torch.equal(p, before[n]) for n, p in _trained(model).items()),
                      applied_steps=[g["applied_steps"] for g in optimizer.param_groups],
                      adam_state=len(optimizer.state))
    return out


@pytest.fixture(scope="module")
def hoi_runs(tmp_path_factory):
    """The whole-batch step and both ranks' results; the reference
    gradients and parameters handed to the ranks are removed when the module
    ends."""
    tmp_path = tmp_path_factory.mktemp("ddp_hoi")
    try:
        batch = make_batch(GLOBAL_BATCH, CANVAS, with_targets=True, device="cpu")
        model, want = _hoi_step(batch, _gumbel(), _sgd)
        trained = _trained(model)
        assert batch.targets is not None and want["applied"]
        torch.save(dict(grads={n: p.grad for n, p in trained.items()},
                        params={n: p.detach() for n, p in trained.items()}),
                   tmp_path / "reference.pt")
        del model, trained
        yield want, _run_ranks(tmp_path, _hoi_rank, str(tmp_path / "reference.pt"))
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def test_ddp_step_losses_equal_whole_batch(hoi_runs):
    want, ranks = hoi_runs
    for r, got in enumerate(ranks):
        assert got["applied"]
        for k, v in want["losses"].items():
            assert v > 0, f"{k} is 0: the comparison would be vacuous"
            np.testing.assert_allclose(got["losses"][k], v, rtol=2e-4, err_msg=f"rank {r} {k}")
        np.testing.assert_allclose(got["total"], want["total"], rtol=2e-4)


def test_ddp_step_gradients_equal_whole_batch(hoi_runs):
    _, ranks = hoi_runs
    for r, got in enumerate(ranks):
        assert len(got["grad_err"]) > 100
        for name, (err, scale) in got["grad_err"].items():
            assert err <= 1e-3 * scale, (r, name, err, scale)


def test_ddp_step_parameters_identical_across_ranks(hoi_runs):
    _, ranks = hoi_runs
    for r, got in enumerate(ranks):
        assert got["same_across_ranks"]
        for name, (err, scale) in got["param_err"].items():
            assert err <= 1e-3 * scale, (r, name, err, scale)


def test_ddp_nan_on_one_rank_skips_both(hoi_runs):
    _, ranks = hoi_runs
    for r, got in enumerate(ranks):
        nan = got["nan"]
        assert not nan["applied"] and np.isnan(nan["total"]), r
        assert nan["unchanged"] and set(nan["applied_steps"]) == {0} and nan["adam_state"] == 0, r


# --- train_kge --data-parallel ----------------------------------------------------

E, R, B, K, DIM, STEPS = 30, 4, 16, 5, 8, 3


def _kge_batches():
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        h, t, r = rng.integers(0, E, B), rng.integers(0, E, B), rng.integers(0, R, B)
        out.append(TripleBatch(h, t, r, rng.integers(0, E, (B, K)), rng.integers(0, E, (B, K)),
                               np.repeat(r[:, None], K, 1)))
    return out


def _kge_train(data_parallel):
    """Three Adam steps of DistMult (Softplus, L2 regularisation); each rank
    takes its half of every batch.  Returns (losses, state_dict)."""
    rng = np.random.default_rng(0)
    triples = np.stack([rng.integers(0, E, 120), rng.integers(0, E, 120),
                        rng.integers(0, R, 120)], axis=1)
    model = models.DistMult(E, R, dim=DIM)
    model.reset_parameters(torch.Generator().manual_seed(3))
    batches = _kge_batches()
    if data_parallel:
        batches = [shard_batch(b) for b in batches]
    feed = iter(batches)
    trainer = Trainer(model, NegativeSampling(loss=SoftplusLoss(), regul_rate=0.1),
                      DeviceKG.from_kgdata(KGData.build(E, R, triples)), nbatches=1,
                      train_times=STEPS, alpha=1e-2, opt_method="adam",
                      batches=lambda: next(feed), log_fn=lambda s: None)
    losses = [trainer.step().item() for _ in range(STEPS)]
    return losses, {k: v.clone() for k, v in model.state_dict().items()}


def test_kge_data_parallel_equals_whole_batch(tmp_path):
    want_losses, want = _kge_train(False)
    for r, (losses, state) in enumerate(_run_ranks(tmp_path, _kge_train, True)):
        np.testing.assert_allclose(losses, want_losses, rtol=1e-6, err_msg=f"rank {r}")
        for name, p in state.items():
            scale = want[name].abs().max().item()
            err = (p - want[name]).abs().max().item()
            assert err <= 1e-5 * scale, (r, name, err, scale)


# --- the engine -------------------------------------------------------------------

SMALL = dict(min_size=64, max_size=107, canvas_landscape=(64, 96), canvas_portrait=(96, 64))


def _engine_rank(root, cache):
    factory = DataFactory("hicodet", "train2015", root, f"{root}/detections_train2015", flip=True,
                          seed=1, **SMALL)
    loader = HOILoader(factory, 2, shuffle=True, with_targets=True, seed=1,
                       num_shards=distributed.world_size(), shard_index=distributed.rank())
    engine = LearningEngine(build_model(device="cpu", seed=INIT_SEED), loader,
                            object_verb_mask=factory.dataset.object_verb_mask(), print_interval=1,
                            cache_dir=cache, seed=3)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        engine.run(1)
    sums = [(p.double().sum().item(), p.double().abs().sum().item())
            for p in engine.model.parameters()]
    return dict(own=len(loader), steps=engine.iteration, losses=engine.step_losses, sums=sums,
                log=text.getvalue())


def test_engine_over_two_ranks(tmp_path):
    root = str(tmp_path / "synth")
    make_synthetic_hicodet(root, "train2015", num_images=5, seed=0)
    cache = tmp_path / "ck"
    r0, r1 = _run_ranks(tmp_path, _engine_rank, root, str(cache))
    assert (r0["own"], r1["own"]) == (2, 1)
    assert r0["steps"] == r1["steps"] == 2
    assert r0["losses"] == r1["losses"] and all(v > 0 for v in r0["losses"][0].values())
    assert r0["sums"] == r1["sums"]
    epoch0 = [l for l in r0["log"].splitlines() if l.startswith("Epoch: 0 | training mAP: ")]
    assert len(epoch0) == 1 and "Epoch:" not in r1["log"] and "=> HOI" not in r1["log"]
    assert sorted(p.name for p in cache.iterdir()) == ["ckpt_01.pt"]


"""The program's named spans (``skghoi_torch.utils.profiling.span``) on the CPU.

With no profiler recording, a train step, an AdaMixer train step and a DETR
call enter no ``record_function`` (counted by patching the helper's own
call; forced on, the same counts are seven and twenty-one, so the test
sees what it checks).  Under ``torch.profiler`` a train step holds each span
of its own list once, nested and ordered as the step runs;
``train_detector``'s AdaMixer step holds ``to_device``, ``ground_truth``,
``forward``, ``resnet50``, ``decoder``, a ``sample`` and a ``mixing`` for
each of its 6 stages, ``match``, ``set_loss``, ``backward`` and
``optimizer`` in that order; a DETR call holds ``resnet50`` alone.  Two train steps of each give bit for bit the same losses and
parameters with the profiler on and off.  At 64x96, float32, two torch
threads.
"""

import torch
from torch.profiler import ProfilerActivity, profile

from skghoi_torch.data.factory import to_device
from skghoi_torch.detect.adamixer import AdaMixerDetector
from skghoi_torch.detect.detr import DETR
from skghoi_torch.entry import build_model, make_batch, verb_mask
from skghoi_torch.models.graph_head import gumbel_noise
from skghoi_torch.parallel.train_step import build_train_step
from skghoi_torch.tools.train_detector import adamw, build_adamixer_step, train_batch
from skghoi_torch.train.optimizer import build_optimizer
from skghoi_torch.utils import profiling
from skghoi_torch.utils.profiling import SPANS

torch.set_num_threads(2)

CANVAS = (64, 96)
BATCH = 2
# The spans of the SCG's train step (parallel.train_step), in order.
SCG_STEP = ("to_device", "forward", "resnet50", "filter", "backward", "guard", "optimizer")
STAGES = 6
# train_detector's AdaMixer step: each stage samples, then mixes.
ADAMIXER_STEP = ("to_device", "ground_truth", "forward", "resnet50", "decoder",
                 *[name for _ in range(STAGES) for name in ("sample", "mixing")],
                 "match", "set_loss", "backward", "optimizer")


def _numpy_batch():
    host = make_batch(BATCH, CANVAS, with_targets=True, device="cpu")
    return type(host)(*(t.numpy() for t in host[:-1]),
                      type(host.targets)(*(t.numpy() for t in host.targets)))


def _train(seed: int = 0):
    """``run()`` does one step as the train loop does: ``to_device`` of a
    collated batch, then the step with a fixed TransH noise."""
    model = build_model(device="cpu", seed=seed)
    step = build_train_step(model, build_optimizer(model), verb_mask(device="cpu"))
    numpy_batch = _numpy_batch()
    gumbel = gumbel_noise((BATCH, 15 * 30 * 117), torch.Generator().manual_seed(1), "cpu")

    def run():
        return step(to_device(numpy_batch, "cpu"), gumbel=gumbel)

    return model, run


def _adamixer():
    """``run()`` is one batch of ``train_detector --arch adamixer
    --frozen-stages 1``: ``train_batch`` on a collated numpy batch."""
    model = AdaMixerDetector(device="cpu", frozen_stages=1, num_queries=10, num_stages=STAGES,
                             content_dim=64, in_points=8, out_points=16, ffn_dim=128)
    step = build_adamixer_step(model, adamw(model, 1e-4, 1e-4))
    numpy_batch = _numpy_batch()

    def run():
        return train_batch(step, numpy_batch, "cpu", "adamixer")

    return model, run


def _detr():
    model = DETR(num_layers=1, num_queries=10, device="cpu").eval()
    images = torch.rand(1, *CANVAS, 3, generator=torch.Generator().manual_seed(2))

    @torch.no_grad()
    def run():
        return model.raw(images)

    return run


def _spans(prof):
    """``{name: [(start, end), ...]}`` of the ``skghoi.`` ranges, in order."""
    out = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name.startswith("skghoi."):
            out.setdefault(e.name[len("skghoi."):], []).append(
                (e.time_range.start, e.time_range.end))
    return out


def _entries(monkeypatch, run, forced: bool) -> int:
    calls = []
    real = profiling.record_function

    def counted(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counted)
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: forced)
    run()
    return len(calls)


def test_no_record_function_without_a_profiler(monkeypatch):
    _, train = _train()
    _, adamixer = _adamixer()
    detr = _detr()
    assert _entries(monkeypatch, train, forced=False) == 0
    assert _entries(monkeypatch, adamixer, forced=False) == 0
    assert _entries(monkeypatch, detr, forced=False) == 0
    assert _entries(monkeypatch, train, forced=True) == len(SCG_STEP)
    assert _entries(monkeypatch, adamixer, forced=True) == len(ADAMIXER_STEP) == 21
    assert _entries(monkeypatch, detr, forced=True) == 1
    assert set(SCG_STEP) | set(ADAMIXER_STEP) == set(SPANS)


def test_span_is_one_shared_no_op_when_off():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("forward") is profiling.span("guard")
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("forward") is not profiling.span("forward")


def test_train_step_holds_each_span_once_in_order():
    _, train = _train()
    train()  # the first step builds AdamW's state
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train()
    spans = _spans(prof)
    assert sorted(spans) == sorted(SCG_STEP)
    assert all(len(v) == 1 for v in spans.values()), spans
    (fwd,), (bwd,), (guard,), (opt,) = (spans[k] for k in ("forward", "backward", "guard",
                                                          "optimizer"))
    for inner in ("resnet50", "filter"):
        (a, b), = spans[inner]
        assert fwd[0] <= a and b <= fwd[1], inner
    assert spans["resnet50"][0][1] <= spans["filter"][0][0]
    assert spans["to_device"][0][1] <= fwd[0] and fwd[1] <= bwd[0]
    assert bwd[1] <= guard[0] and guard[1] <= opt[0]


def test_adamixer_step_holds_its_spans_in_order():
    """``train_batch`` of the AdaMixer step: the batch to the device, the
    ground truth and its de-duplication, the forward (the body, then the
    decoder with each stage's sampling and mixing inside it), the host
    match, the set loss, the backward and AdamW, each span
    closing before the next opens but for the nesting."""
    _, run = _adamixer()
    run()  # the first step builds AdamW's state
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    events = sorted((e.time_range.start, -e.time_range.end, e.name[len("skghoi."):],
                     e.time_range.end) for e in prof.events() if e.name.startswith("skghoi."))
    assert [name for _, _, name, _ in events] == list(ADAMIXER_STEP)
    spans = {}
    for start, _, name, end in events:
        spans.setdefault(name, []).append((start, end))
    (fwd,), (dec,), (body,) = spans["forward"], spans["decoder"], spans["resnet50"]
    assert fwd[0] <= body[0] and body[1] <= dec[0] and dec[1] <= fwd[1]
    inner = sorted(spans["sample"] + spans["mixing"])
    assert all(dec[0] <= a and b <= dec[1] for a, b in inner)
    assert all(b <= a2 for (_, b), (a2, _) in zip(inner, inner[1:]))
    order = [spans[k][0] for k in ("to_device", "ground_truth", "forward", "match", "set_loss",
                                   "backward", "optimizer")]
    assert all(b <= a2 for (_, b), (a2, _) in zip(order, order[1:]))


def test_detr_holds_the_body_span_alone():
    detr = _detr()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        detr()
    spans = _spans(prof)
    assert list(spans) == ["resnet50"] and len(spans["resnet50"]) == 1


def test_spans_change_no_bit():
    """Two steps from the same weights, profiled and not: equal losses and
    parameters, bit for bit."""
    results = []
    for traced in (False, True):
        model, train = _train(seed=3)
        losses = []
        for _ in range(2):
            if traced:
                with profile(activities=[ProfilerActivity.CPU]):
                    total, parts, _, applied = train()
            else:
                total, parts, _, applied = train()
            assert applied
            losses.append(torch.stack([total, *parts.values()]))
        results.append((torch.stack(losses), {n: p.detach().clone()
                                              for n, p in model.named_parameters()}))
    (l_off, p_off), (l_on, p_on) = results
    assert torch.equal(l_off, l_on)
    assert p_off.keys() == p_on.keys()
    assert all(torch.equal(p_off[n], p_on[n]) for n in p_off)


def test_adamixer_spans_change_no_bit():
    """Two AdaMixer steps from the same weights, profiled and not: equal
    losses and parameters, bit for bit."""
    results = []
    for traced in (False, True):
        model, run = _adamixer()
        losses = []
        for _ in range(2):
            if traced:
                with profile(activities=[ProfilerActivity.CPU]):
                    losses.append(run()["set_loss"])
            else:
                losses.append(run()["set_loss"])
        results.append((torch.stack(losses), {n: p.detach().clone()
                                              for n, p in model.named_parameters()}))
    (l_off, p_off), (l_on, p_on) = results
    assert torch.equal(l_off, l_on)
    assert p_off.keys() == p_on.keys()
    assert all(torch.equal(p_off[n], p_on[n]) for n in p_off)

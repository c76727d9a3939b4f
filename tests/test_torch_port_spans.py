"""The program's named spans (``skghoi_torch.utils.profiling.span``) on the CPU.

With no profiler recording, a train step and a DETR call enter no
``record_function`` (counted by patching the helper's own call; forced on,
the same count is seven, so the test sees what it checks).  Under
``torch.profiler`` a train step holds each span of ``SPANS`` once, nested
and ordered as the step runs, and a DETR call holds ``resnet50`` alone.
Two train steps give bit for bit the same losses and parameters with the
profiler on and off.  At 64x96, float32, two torch threads.
"""

import torch
from torch.profiler import ProfilerActivity, profile

from skghoi_torch.data.factory import to_device
from skghoi_torch.detect.detr import DETR
from skghoi_torch.entry import build_model, make_batch, verb_mask
from skghoi_torch.models.graph_head import gumbel_noise
from skghoi_torch.parallel.train_step import build_train_step
from skghoi_torch.train.optimizer import build_optimizer
from skghoi_torch.utils import profiling
from skghoi_torch.utils.profiling import SPANS

torch.set_num_threads(2)

CANVAS = (64, 96)
BATCH = 2


def _train(seed: int = 0):
    """``run()`` does one step as the train loop does: ``to_device`` of a
    collated batch, then the step with a fixed TransH noise."""
    model = build_model(device="cpu", seed=seed)
    step = build_train_step(model, build_optimizer(model), verb_mask(device="cpu"))
    host = make_batch(BATCH, CANVAS, with_targets=True, device="cpu")
    numpy_batch = type(host)(*(t.numpy() for t in host[:-1]),
                             type(host.targets)(*(t.numpy() for t in host.targets)))
    gumbel = gumbel_noise((BATCH, 15 * 30 * 117), torch.Generator().manual_seed(1), "cpu")

    def run():
        return step(to_device(numpy_batch, "cpu"), gumbel=gumbel)

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
    detr = _detr()
    assert _entries(monkeypatch, train, forced=False) == 0
    assert _entries(monkeypatch, detr, forced=False) == 0
    assert _entries(monkeypatch, train, forced=True) == len(SPANS)
    assert _entries(monkeypatch, detr, forced=True) == 1


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
    assert sorted(spans) == sorted(SPANS)
    assert all(len(v) == 1 for v in spans.values()), spans
    (fwd,), (bwd,), (guard,), (opt,) = (spans[k] for k in ("forward", "backward", "guard",
                                                          "optimizer"))
    for inner in ("resnet50", "filter"):
        (a, b), = spans[inner]
        assert fwd[0] <= a and b <= fwd[1], inner
    assert spans["resnet50"][0][1] <= spans["filter"][0][0]
    assert spans["to_device"][0][1] <= fwd[0] and fwd[1] <= bwd[0]
    assert bwd[1] <= guard[0] and guard[1] <= opt[0]


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

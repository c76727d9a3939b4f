"""The program's ``skghoi.`` spans in a traced window (``hoibench/spans.py``)
and the six readers over them, on hand-built traces (times in us)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from hoibench import harness
from hoibench.spans import idle_under, launches_under
from hoibench.trace import Trace

READERS = ("filter_launches.train", "filter_idle_ms.train", "resnet_launches.train",
           "resnet_launches.infer", "guard_idle_ms.train", "to_device_idle_ms.train")


def _event(name, start, end, device=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU)


def step_events():
    """One train step of 100 us: device busy 0-12, 30-40, 55-60, 75-100."""
    return [
        _event("hoibench.window", 0.0, 100.0),
        _event("skghoi.to_device", 0.0, 5.0),
        _event("skghoi.forward", 5.0, 45.0),
        _event("skghoi.resnet50", 5.0, 10.0),
        _event("cudaLaunchKernel", 6.0, 6.5),
        _event("cudaLaunchKernel", 8.0, 8.5),
        _event("skghoi.filter", 10.0, 25.0),
        _event("cuLaunchKernel", 15.0, 15.5),
        _event("skghoi.backward", 45.0, 52.0),
        # autograd's thread launches while the caller's span is open
        _event("autograd::engine::evaluate_function: ConvBackward", 46.0, 48.0),
        _event("cudaLaunchKernel", 47.0, 47.5),
        _event("skghoi.guard", 52.0, 62.0),
        _event("skghoi.optimizer", 62.0, 90.0),
        _event("cudaLaunchKernel", 70.0, 70.5),
        _event("kernel_a", 0.0, 12.0, device=True),
        _event("kernel_b", 30.0, 40.0, device=True),
        _event("kernel_c", 55.0, 60.0, device=True),
        _event("kernel_d", 75.0, 100.0, device=True),
    ]


def _step():
    return Trace(step_events())


def test_launches_under_a_span_count_on_any_thread():
    tr = _step()
    assert tr.launches == 5
    assert launches_under(tr, ("resnet50",)) == 2
    assert launches_under(tr, ("filter",)) == 1
    assert launches_under(tr, ("backward",)) == 1  # from autograd's thread
    assert launches_under(tr, ("forward",)) == 3  # its inner spans' too
    assert launches_under(tr, ("guard", "optimizer")) == 1


def test_a_gap_from_guard_into_optimizer_counts_once():
    tr = _step()
    # gaps 12-30 (begins under filter), 40-55 (forward), 60-75 (guard, into optimizer)
    assert idle_under(tr, ("guard", "optimizer")) == pytest.approx(15e-6)
    assert idle_under(tr, ("guard",)) == pytest.approx(15e-6)
    assert idle_under(tr, ("optimizer",)) == 0.0


def test_a_gap_under_forward_outside_filter_is_not_the_filters():
    tr = _step()
    assert idle_under(tr, ("filter",)) == pytest.approx(18e-6)
    assert idle_under(tr, ("forward",)) == pytest.approx(15e-6)
    assert idle_under(tr, ("backward",)) == 0.0


def test_readers_per_unit():
    ctx = harness.Context(_step(), None, 2, None)
    got = {m: harness.load_reader(m).read(ctx) for m in READERS}
    assert got == pytest.approx({
        "filter_launches.train": 0.5, "filter_idle_ms.train": 0.009,
        "resnet_launches.train": 1.0, "resnet_launches.infer": 1.0,
        "guard_idle_ms.train": 0.0075, "to_device_idle_ms.train": 0.0})


def test_readers_return_none_without_their_spans():
    """An older program has no ``skghoi.`` spans; a CPU trace has no device
    rows and no launches."""
    step = _step()
    no_spans = Trace([e for e in step_events() if not e.name.startswith("skghoi.")])
    no_device = Trace([e for e in step_events()
                       if e.device_type.name == "CPU" and "Launch" not in e.name])
    for tr in (no_spans, no_device):
        ctx = harness.Context(tr, None, 1, None)
        assert {m: harness.load_reader(m).read(ctx) for m in READERS} == dict.fromkeys(READERS)
    assert step.launches and step.device

"""The FrozenBatchNorm kernels' readers, ``frozen_bn_ms.infer`` and
``frozen_bn_launches.train``, on hand-built traces (times in us)."""

from __future__ import annotations

import pytest

from hoibench import harness
from hoibench.tests.test_hoibench_spans import _event
from hoibench.trace import Trace

READERS = ("frozen_bn_ms.infer", "frozen_bn_launches.train")
FORWARD = "void (anonymous namespace)::frozen_bn_forward_kernel<__nv_bfloat16, 8, true>(...)"
BACKWARD = "void (anonymous namespace)::frozen_bn_backward_kernel<__nv_bfloat16, 8, true>(...)"
ELEMENTWISE = "void at::native::elementwise_kernel<128, 4, ...>(int, ...)"


def _trace(names):
    events = [_event("hoibench.window", 0.0, 100.0)]
    events += [_event(n, 10.0 * i, 10.0 * i + 4.0, device=True) for i, n in enumerate(names)]
    return Trace(events)


def test_readers_per_unit():
    ctx = harness.Context(_trace([FORWARD, BACKWARD, FORWARD, ELEMENTWISE]), None, 2, None)
    got = {m: harness.load_reader(m).read(ctx) for m in READERS}
    assert got == pytest.approx({"frozen_bn_ms.infer": 0.006, "frozen_bn_launches.train": 1.5})


def test_readers_return_none_without_the_kernels():
    """The parent's body runs PyTorch's elementwise kernels only."""
    ctx = harness.Context(_trace([ELEMENTWISE, ELEMENTWISE]), None, 1, None)
    assert {m: harness.load_reader(m).read(ctx) for m in READERS} == dict.fromkeys(READERS)


def test_the_kernels_are_not_counted_as_elementwise():
    ctx = harness.Context(_trace([FORWARD, BACKWARD]), None, 1, None)
    assert harness.load_reader("elementwise_ms.infer").read(ctx) is None

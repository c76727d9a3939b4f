"""The AdaMixer sampling kernels' reader, ``sample_kernel_launches.adamixer``,
on hand-built traces (times in us); the fault that ``adamixer_kernel_faults``
plants on the kernels' route, around a stand-in kernel."""

from __future__ import annotations

import pytest

from hoibench import harness
from hoibench.tests.test_hoibench_spans import _event
from hoibench.trace import Trace

READER = "sample_kernel_launches.adamixer"
FORWARD = ("void (anonymous namespace)::adamixer_sample_forward_kernel<float>((anonymous "
           "namespace)::Levels, float const*, float const*, float*, long, long, int)")
ADJOINT = "void (anonymous namespace)::adamixer_sample_adjoint_kernel<float>(...)"
GATHER = "void at::native::_scatter_gather_elementwise_kernel<128, 8, ...>(int, ...)"


def _trace(names):
    events = [_event("hoibench.window", 0.0, 1000.0)]
    events += [_event(n, 10.0 * i, 10.0 * i + 4.0, device=True) for i, n in enumerate(names)]
    return Trace(events)


def test_reads_both_kernels_per_step():
    ctx = harness.Context(_trace([FORWARD, GATHER] * 6 + [ADJOINT] * 6), None, 1, None)
    assert harness.load_reader(READER).read(ctx) == pytest.approx(12.0)
    ctx = harness.Context(_trace([FORWARD, ADJOINT] * 12), None, 2, None)
    assert harness.load_reader(READER).read(ctx) == pytest.approx(12.0)


def test_reads_none_without_the_kernels():
    """The parent samples with eager gathers."""
    ctx = harness.Context(_trace([GATHER] * 96), None, 1, None)
    assert harness.load_reader(READER).read(ctx) is None


def test_the_kernel_fault_drops_the_tap_that_dropped_tap_drops():
    """``kernel_dropped_tap`` around a stand-in forward kernel (the eager
    route) gives what ``adamixer_faults.dropped_tap`` gives the eager route;
    the plant swaps the program's kernel object for the faulty one and puts
    it back."""
    import torch

    from hoibench import adamixer_faults, adamixer_kernel_faults, faults
    from skghoi_torch.detect import adamixer as A

    g = torch.Generator().manual_seed(0)
    hw = [(16 // s, 24 // s) for s in (1, 2, 4, 8)]
    feats = [torch.randn(2, 4, h * w, 8, generator=g, dtype=torch.float64) for h, w in hw]
    points = torch.stack([torch.rand(2, 4, 20, generator=g, dtype=torch.float64) * 110 - 7,
                          torch.rand(2, 4, 20, generator=g, dtype=torch.float64) * 80 - 8,
                          torch.rand(2, 4, 20, generator=g, dtype=torch.float64) * 4 + 1], -1)
    wts = torch.softmax(torch.randn(2, 4, 20, 4, generator=g, dtype=torch.float64), -1)
    levels = [(f, h, w) for f, (h, w) in zip(feats, hw)]

    def eager_kernel(feats, hw, inv_strides, points, wts):
        return A._sample_levels([(f, h, w) for f, (h, w) in zip(feats, hw)], points, wts)

    got = adamixer_kernel_faults.DroppedTapKernel(eager_kernel)(feats, hw, A.INV_STRIDES,
                                                                points, wts)
    with adamixer_faults._dropped_tap(None):
        want = A._sample_levels(levels, points, wts)
    whole = A._sample_levels(levels, points, wts)
    assert (whole - want).abs().max() > 1e-3
    assert torch.allclose(got, want, rtol=0, atol=1e-12)

    real = A.sample_cuda
    with adamixer_kernel_faults.extended(), faults.plant("kernel_dropped_tap", None):
        assert isinstance(A.sample_cuda, adamixer_kernel_faults.DroppedTapKernel)
        assert A.sample_cuda.kernel is real and A.sample_cuda.adjoint == real.adjoint
    assert A.sample_cuda is real and "kernel_dropped_tap" not in faults.PLANTS

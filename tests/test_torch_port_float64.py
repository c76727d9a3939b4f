"""The float64 copies ``chip_smoke.py`` compares the card with compute in float64.

Phase 13 of ``chip_smoke.py`` holds the card's gradients of the stage-1
detectors to the CPU's through ``chip_smoke._float64_copy`` of each model.
A layer that computes in float32 inside such a copy puts float32 rounding
(~1e-7) into a comparison that is bounded as float64's (~1e-13), and the
trained AdaMixer decoder magnifies it past ``S1_GRAD64_TOL``.

- forward and backward of the float64 ``FPNDetector`` (full widths) and of a
  small ``AdaMixerDetector`` produce no floating tensor below float64;
- ``FrozenBatchNorm`` in float32 and bfloat16 is bit for bit the formula the
  JAX package uses (constants in float32), with seeded statistics;
- in float64 it is within 1e-15 of a numpy float64 formula.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import chip_smoke
from skghoi_torch.detect import adamixer as A
from skghoi_torch.detect import detector as D
from skghoi_torch.models.resnet import FrozenBatchNorm

torch.set_num_threads(2)

CANVAS = (64, 96)
SMALL = dict(num_queries=8, num_stages=2, groups=4, in_points=8, out_points=16, ffn_dim=128)
FROZEN_BN_LAYERS = 53  # ResNet-50: the stem's, 3 a bottleneck, 4 projections


class _BelowFloat64(TorchDispatchMode):
    """Counts, by op and dtype, every floating output below float64, and
    every floating op output in all."""

    def __init__(self):
        super().__init__()
        self.below, self.total = Counter(), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                self.total += 1
                if t.dtype != torch.float64:
                    self.below[(func.__name__, str(t.dtype))] += 1
        return out


def _images():
    return torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, *CANVAS, 3))
                            .astype(np.float32))


@pytest.mark.parametrize("arch", ["fpn", "adamixer"])
def test_float64_copy_computes_in_float64(arch):
    """The forward of ``_float64_copy`` and the backward from seeded float64
    cotangents on every output log no floating op output below float64 (a
    float32 FrozenBatchNorm logs 9 ops a layer).  The losses are left out:
    they build their targets (counts, one-hot classes, anchors) from the
    float32 data, values that float32 holds exactly."""
    images, rng = _images(), np.random.default_rng(1)
    if arch == "fpn":  # images as phase 13 gives them: the FPN's float64, AdaMixer's float32
        model, images = D.FPNDetector(device="cpu"), images.double()
    else:
        model = A.AdaMixerDetector(content_dim=64, device="cpu", **SMALL)
    model = chip_smoke._float64_copy(model)
    assert sum(isinstance(m, FrozenBatchNorm) for m in model.modules()) == FROZEN_BN_LAYERS
    with _BelowFloat64() as mode:
        outputs = tuple(model(images))
        cotangents = [torch.from_numpy(rng.normal(size=tuple(o.shape))) for o in outputs]
        torch.autograd.backward(outputs, cotangents)
    assert all(o.dtype == torch.float64 and torch.isfinite(o).all() for o in outputs)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert len(grads) > 80 and all(g.dtype == torch.float64 for g in grads)
    assert mode.total > 1000 and not mode.below, dict(mode.below)


def _seeded_bn(channels, seed):
    rng = np.random.default_rng(seed)
    stats = dict(weight=rng.uniform(0.5, 2.0, channels), bias=rng.normal(0.0, 0.5, channels),
                 running_mean=rng.normal(0.0, 1.0, channels),
                 running_var=rng.uniform(1e-3, 4.0, channels))
    bn = FrozenBatchNorm(channels)
    for name, value in stats.items():
        getattr(bn, name).copy_(torch.from_numpy(value.astype(np.float32)))
    x = rng.normal(0.0, 3.0, (2, channels, 5, 7)).astype(np.float32)
    return bn, torch.from_numpy(x).to(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_frozen_batchnorm_float32_constants_bit_for_bit(dtype):
    """Float32 statistics keep the constants in float32, as the JAX package
    does, and so the output of every float32 and bfloat16 model."""
    bn, x = _seeded_bn(64, 1)
    bn.compute_dtype = dtype
    inv = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    shift = bn.bias.float() - bn.running_mean.float() * inv
    want = x.to(dtype) * inv.to(dtype).view(1, -1, 1, 1) + shift.to(dtype).view(1, -1, 1, 1)
    got = bn(x)
    assert got.dtype == dtype and torch.equal(got, want)


def test_frozen_batchnorm_float64_copy_equals_numpy():
    """Buffers made float64 by ``.double()`` give float64 constants."""
    bn, x = _seeded_bn(64, 2)
    want_inv = bn.weight.double().numpy() / np.sqrt(bn.running_var.double().numpy() + bn.eps)
    want_shift = bn.bias.double().numpy() - bn.running_mean.double().numpy() * want_inv
    want = (x.double().numpy() * want_inv[None, :, None, None]
            + want_shift[None, :, None, None])
    got = chip_smoke._float64_copy(bn)(x.double())
    assert got.dtype == torch.float64
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-15 * np.abs(want).max(), err

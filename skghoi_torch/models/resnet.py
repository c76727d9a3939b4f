"""ResNet-50 with frozen BatchNorm, torchvision layout, channels_last.

Mirrors ``skghoi_tpu.models.resnet.ResNet50``: a plain 7x7/2 stem (the
space-to-depth stem and the ``nn.scan`` tail blocks there are TPU compile
levers with identical math), BatchNorm that always uses its stored statistics
(all four of its terms are buffers, so no optimizer sees them), the C2..C5
outputs at strides 4, 8, 16, 32, mmdet's ``frozen_stages`` and
``remat_stages`` (activation recomputation, ``torch.utils.checkpoint``).
Module names follow torchvision's ``resnet50`` so its checkpoints load by
name.

Tensors are NCHW in ``torch.channels_last`` memory, which cuDNN runs natively
and which permutes to a contiguous NHWC view for free.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from skghoi_torch.models.layers import Conv2d
from skghoi_torch.ops.frozen_bn_cuda import frozen_bn_act
from skghoi_torch.utils.profiling import span

Tensor = torch.Tensor


class FrozenBatchNorm(nn.Module):
    """BatchNorm over stored statistics, folded into one multiply-add, with the
    ReLU and the residual add of its site: ``forward(x, residual, relu)`` is
    ``act(x * inv + shift [+ residual])``, one kernel on the card
    (:func:`skghoi_torch.ops.frozen_bn_cuda.frozen_bn_act`).

    The per-channel constants are computed in the statistics' dtype promoted to
    at least float32: float32 for the float32 buffers every float32 and
    bfloat16 model keeps (as ``skghoi_tpu.models.resnet.FrozenBatchNorm``),
    float64 once ``.double()`` has made the buffers float64; then they are kept
    in ``dtype``, as the activation (eps 1e-5).  They are computed again only
    when a buffer is replaced or written in place (``load_state_dict``,
    ``.to``, ``.double()``, a ``copy_``), or ``dtype`` or ``eps`` changes.
    """

    def __init__(self, channels: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self._constants = None  # (what they were computed from, those buffers, inv, shift)

    def constants(self) -> Tuple[Tensor, Tensor]:
        """``inv`` and ``shift``, ``[C]`` in ``compute_dtype``."""
        buffers = (self.weight, self.bias, self.running_mean, self.running_var)
        try:
            state = (self.compute_dtype, self.eps,
                     *[(id(b), b._version, b.dtype, b.device) for b in buffers])
        except RuntimeError:  # inference tensors keep no version counter: no cache
            return self._fold()
        cached = self._constants
        # Constants made under inference_mode cannot be saved for a backward.
        if (cached is None or cached[0] != state
                or (cached[2].is_inference() and not torch.is_inference_mode_enabled())):
            # The buffers are kept with their ids, so no id can be reused while cached.
            cached = self._constants = (state, buffers, *self._fold())
        return cached[2], cached[3]

    def _fold(self) -> Tuple[Tensor, Tensor]:
        ct = torch.promote_types(self.running_var.dtype, torch.float32)
        inv = torch.rsqrt(self.running_var.to(ct) + self.eps) * self.weight.to(ct)
        shift = self.bias.to(ct) - self.running_mean.to(ct) * inv
        return inv.to(self.compute_dtype), shift.to(self.compute_dtype)

    def forward(self, x: Tensor, residual: Optional[Tensor] = None, relu: bool = False) -> Tensor:
        inv, shift = self.constants()
        return frozen_bn_act(x.to(self.compute_dtype), inv, shift, residual, relu)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with identity/projection shortcut."""

    def __init__(self, in_channels: int, width: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = width * 4
        self.conv1 = Conv2d(in_channels, width, 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(width, dtype=dtype)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1, bias=False, dtype=dtype)
        self.bn2 = FrozenBatchNorm(width, dtype=dtype)
        self.conv3 = Conv2d(width, out, 1, bias=False, dtype=dtype)
        self.bn3 = FrozenBatchNorm(out, dtype=dtype)
        self.downsample = None
        if in_channels != out or stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(in_channels, out, 1, stride=stride, bias=False, dtype=dtype),
                FrozenBatchNorm(out, dtype=dtype),
            )

    def forward(self, x: Tensor) -> Tensor:
        y = self.bn1(self.conv1(x), relu=True)
        y = self.bn2(self.conv2(y), relu=True)
        residual = x if self.downsample is None else self.downsample(x)
        return self.bn3(self.conv3(y), residual, relu=True)


class ResNet50(nn.Module):
    """Returns C2..C5 (strides 4, 8, 16, 32) as NCHW channels_last tensors.

    ``frozen_stages`` has mmdet's meaning: -1 trains everything, 0 freezes
    the stem, ``k`` the stem and ``layer1..layer{k}``.  Frozen parameters get
    ``requires_grad=False`` and the activation is detached at the frozen
    prefix's boundary, so no backward runs through it.  ``remat_stages``
    (1-based, 0 = off) recomputes each bottleneck of that stage and later
    ones in the backward instead of keeping its activations.
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32, frozen_stages: int = -1,
                 remat_stages: int = 0):
        super().__init__()
        self.compute_dtype = dtype
        self.frozen_stages = frozen_stages
        self.remat_stages = remat_stages
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64, dtype=dtype)
        in_ch = 64
        for stage, (blocks, width) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(in_ch, width, 2 if (b == 0 and stage > 0) else 1, dtype))
                in_ch = width * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        if frozen_stages >= 0:
            self.conv1.requires_grad_(False)
        for stage in range(1, frozen_stages + 1):
            getattr(self, f"layer{stage}").requires_grad_(False)

    def forward(self, x: Tensor) -> Tuple[Tensor, ...]:
        with span("resnet50"):
            x = x.to(self.compute_dtype).contiguous(memory_format=torch.channels_last)
            x = self.bn1(self.conv1(x), relu=True)
            x = F.max_pool2d(x, 3, stride=2, padding=1)
            if self.frozen_stages >= 0:
                x = x.detach()
            outputs = []
            for stage, layer in enumerate((self.layer1, self.layer2, self.layer3, self.layer4), 1):
                if self.remat_stages and stage >= self.remat_stages and torch.is_grad_enabled():
                    for block in layer:
                        x = checkpoint(block, x, use_reentrant=False)
                else:
                    x = layer(x)
                if self.frozen_stages >= stage:
                    x = x.detach()
                outputs.append(x)
            return tuple(outputs)

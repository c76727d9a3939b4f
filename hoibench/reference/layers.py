"""Plain float32 layers of the reference, and the lower precision of its control.

Every parameter and activation is float32.  A layer's matrix product
(convolution, linear, batched product) takes its operands through
``quant``: the identity for the reference, and for the control a round trip
through float8 e4m3 with one scale a tensor (its largest magnitude onto
448), the step below bfloat16 that a later change could be tempted to take.
The round trip is a straight-through estimator: the backward sees the
identity, so the control's gradients are float32 products of its float8
forward.

Module and parameter names are those of the program's modules, so that one
state dict made from the seed loads into both.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor
Quant = Callable[[Tensor], Tensor]

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def identity(t: Tensor) -> Tensor:
    return t


def fp8_e4m3(t: Tensor) -> Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale, straight through."""
    scale = FP8_MAX / t.detach().abs().amax().clamp_min(1e-30)
    # Clamped first: float32 rounding can carry the largest entry past 448,
    # which e4m3fn (no infinities) would turn into NaN.
    q = (t.detach() * scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t.detach())


PRECISIONS = {"float32": identity, "fp8": fp8_e4m3}


def quantizer(precision: str) -> Quant:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; known: {sorted(PRECISIONS)}")
    return PRECISIONS[precision]


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = False, quant: Quant = identity):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding, self.quant = stride, padding, quant

    def forward(self, x: Tensor) -> Tensor:
        return F.conv2d(self.quant(x), self.quant(self.weight), self.bias, self.stride,
                        self.padding)


class Lin(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True, quant: Quant = identity):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.quant = quant

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(self.quant(x), self.quant(self.weight), self.bias)


class Norm(nn.Module):
    """LayerNorm over the last axis, eps 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, self.eps)


class FrozenBN(nn.Module):
    """BatchNorm over stored statistics: ``(x - mean) / sqrt(var + eps) * w + b``."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.register_buffer(name, torch.empty(c))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, quant: Quant):
        super().__init__()
        out = width * 4
        self.conv1 = Conv(cin, width, 1, quant=quant)
        self.bn1 = FrozenBN(width)
        self.conv2 = Conv(width, width, 3, stride, 1, quant=quant)
        self.bn2 = FrozenBN(width)
        self.conv3 = Conv(width, out, 1, quant=quant)
        self.bn3 = FrozenBN(out)
        self.downsample = None
        if cin != out or stride != 1:
            self.downsample = nn.Sequential(Conv(cin, out, 1, stride, quant=quant), FrozenBN(out))

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet50(nn.Module):
    """C2..C5 (NCHW).  ``frozen_stages`` as mmdet: the stem and
    ``layer1..layer{k}`` take no gradient and the activation is detached
    after them; -1 trains everything."""

    def __init__(self, frozen_stages: int = -1, quant: Quant = identity):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.conv1 = Conv(3, 64, 7, 2, 3, quant=quant)
        self.bn1 = FrozenBN(64)
        cin = 64
        for stage, (blocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(cin, width, 2 if (b == 0 and stage > 0) else 1, quant))
                cin = width * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        if frozen_stages >= 0:
            self.conv1.requires_grad_(False)
        for stage in range(1, frozen_stages + 1):
            getattr(self, f"layer{stage}").requires_grad_(False)

    def forward(self, x: Tensor) -> Tuple[Tensor, ...]:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            if self.frozen_stages >= stage:
                x = x.detach()
            outs.append(x)
        return tuple(outs)


class FPN(nn.Module):
    def __init__(self, cins: Sequence[int] = (256, 512, 1024, 2048), cout: int = 256,
                 quant: Quant = identity):
        super().__init__()
        self.lateral = nn.ModuleList(Conv(c, cout, 1, bias=True, quant=quant) for c in cins)
        self.output = nn.ModuleList(Conv(cout, cout, 3, 1, 1, bias=True, quant=quant)
                                    for _ in cins)

    def forward(self, feats: Sequence[Tensor]) -> Tuple[Tensor, ...]:
        lat = [conv(f) for conv, f in zip(self.lateral, feats)]
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = lat[i] + lat[i + 1].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return tuple(conv(x) for conv, x in zip(self.output, lat))


class DetectorBackbone(nn.Module):
    """ResNet-50 + FPN: ``[B, H, W, 3]`` -> four ``[B, H_l, W_l, 256]`` maps."""

    def __init__(self, frozen_stages: int, quant: Quant = identity):
        super().__init__()
        self.backbone = ResNet50(frozen_stages, quant)
        self.neck = FPN(quant=quant)

    def forward(self, images: Tensor) -> Tuple[Tensor, ...]:
        pyramid = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return tuple(p.permute(0, 2, 3, 1) for p in pyramid)


def bmm_weight(x: Tensor, w: Tensor, quant: Quant) -> Tensor:
    """``x @ w`` with both operands through ``quant``."""
    return quant(x) @ quant(w)


def init_kinds(model: nn.Module, overrides: Optional[dict] = None) -> dict:
    """How the seed fills each tensor of ``model.state_dict()``: ``("normal",
    std[, mean])``, ``("uniform", bound[, centre])`` (``centre +- bound``) or
    ``("const", value)``.  Convolution and linear weights are LeCun-normal
    with torch's uniform biases; LayerNorm's scale is 1 +- 0.2 and its shift
    N(0, 0.1); a frozen BatchNorm's scale is U(0.5, 1.5), its shift and
    running mean N(0, 0.1) and its running variance U(0.5, 2), so that no
    affine term, statistic or bias is an identity that a fault could drop
    unseen.  ``overrides`` maps a name to its kind."""
    kinds = {}
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, (Conv, Lin)):
            fan_in = m.weight[0].numel()
            kinds[pre + "weight"] = ("normal", fan_in ** -0.5)
            if m.bias is not None:
                kinds[pre + "bias"] = ("uniform", fan_in ** -0.5)
        elif isinstance(m, Norm):
            kinds[pre + "weight"], kinds[pre + "bias"] = ("uniform", 0.2, 1.0), ("normal", 0.1)
        elif isinstance(m, FrozenBN):
            kinds.update({pre + "weight": ("uniform", 0.5, 1.0), pre + "bias": ("normal", 0.1),
                          pre + "running_mean": ("normal", 0.1),
                          pre + "running_var": ("uniform", 0.75, 1.25)})
    kinds.update(overrides or {})
    return kinds

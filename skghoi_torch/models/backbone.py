"""Detector backbone assembly: ResNet-50 + FPN -> P2..P5.

Mirrors ``skghoi_tpu.models.backbone.DetectorBackbone``.  Images come in as
``[B, H, W, 3]``; the pyramid goes out as four ``[B, H_l, W_l, 256]`` maps,
contiguous NHWC (views of the channels_last NCHW tensors the convs produce).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from skghoi_torch.device import resolve_device
from skghoi_torch.models.fpn import FPN
from skghoi_torch.models.resnet import ResNet50

Tensor = torch.Tensor


class DetectorBackbone(nn.Module):
    """backbone -> neck, returning the 4-level pyramid (strides 4, 8, 16, 32).

    Built on ``device`` (default ``cuda``; the CPU only when asked for).
    ``frozen_stages`` and ``remat_stages`` pass through to :class:`ResNet50`."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 frozen_stages: int = -1, remat_stages: int = 0):
        super().__init__()
        self.backbone = ResNet50(dtype=dtype, frozen_stages=frozen_stages,
                                 remat_stages=remat_stages)
        self.neck = FPN(dtype=dtype)
        self.to(device=resolve_device(device), memory_format=torch.channels_last)

    def forward(self, images: Tensor) -> Tuple[Tensor, ...]:
        """``[B, H, W, 3]`` -> four ``[B, H_l, W_l, 256]`` NHWC maps."""
        pyramid = self.neck(self.backbone(images.permute(0, 3, 1, 2)))
        return tuple(p.permute(0, 2, 3, 1) for p in pyramid)

"""Feature Pyramid Network neck producing P2..P5 at 256 channels.

Mirrors ``skghoi_tpu.models.fpn.FPN``: lateral 1x1 projections, exact 2x
nearest-neighbour top-down accumulation, 3x3 output convs.  NCHW in
channels_last memory in and out.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from skghoi_torch.models.layers import Conv2d

Tensor = torch.Tensor


def upsample_nearest_2x(x: Tensor) -> Tensor:
    """Each cell repeated into a 2x2 block (NCHW; keeps channels_last)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lateral = nn.ModuleList(Conv2d(c, out_channels, 1, dtype=dtype) for c in in_channels)
        self.output = nn.ModuleList(
            Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype) for _ in in_channels
        )

    def forward(self, features: Sequence[Tensor]) -> Tuple[Tensor, ...]:
        laterals = [conv(f) for conv, f in zip(self.lateral, features)]
        for i in range(len(laterals) - 2, -1, -1):  # top-down, coarsest first
            laterals[i] = laterals[i] + upsample_nearest_2x(laterals[i + 1])
        return tuple(
            conv(l).contiguous(memory_format=torch.channels_last)
            for conv, l in zip(self.output, laterals)
        )

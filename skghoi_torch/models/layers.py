"""Layers that keep float32 parameters and compute in a chosen dtype.

The JAX package's flax layers take ``dtype=`` the same way: parameters stay
float32, inputs and weights are cast to ``dtype`` and the product is taken
there.  ``dtype=torch.bfloat16`` is the card's serving mode; float32 is the
parity mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computed in ``dtype`` (NCHW in, NCHW out)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        return F.conv2d(x.to(self.compute_dtype), self.weight.to(self.compute_dtype),
                        _cast(self.bias, self.compute_dtype), self.stride, self.padding)


class Linear(nn.Linear):
    """``nn.Linear`` computed in ``dtype``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype),
                        _cast(self.bias, self.compute_dtype))

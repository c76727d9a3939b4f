"""Multi-scale RoIAlign as plain gathers (torchvision ``roi_align``,
``aligned=False``, 7x7 bins, 2x2 samples a bin, levels by ``LevelMapper``
(224, 4, [2, 5])), over NHWC maps, finest first, at strides 4, 8, 16, 32.

Every box is pooled at every level and keeps its assigned level's result:
dense and simple.  Autograd through the gathers gives the maps' gradient.
The level assignment and the sample positions are also what the byte
bounds of ``hoibench.roofline`` count.
"""

from __future__ import annotations

from typing import Sequence

import torch

Tensor = torch.Tensor

STRIDES = (4, 8, 16, 32)
POOLED = 7
SAMPLING = 2


def _div(x: Tensor, d: float) -> Tensor:
    """``x / d`` rounded once (a divisor tensor on ``x``'s device: true division)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def fpn_level(boxes: Tensor) -> Tensor:
    """``[..., 4]`` boxes -> int32 level in ``[0, 3]``."""
    area = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])).clamp_min(0.0)
    lvl = torch.floor(4 + torch.log2(_div(torch.sqrt(area), 224) + 1e-6))
    return (lvl.clamp(2, 5) - 2).to(torch.int32)


def sample_axis(start: Tensor, roi_len: Tensor, size: int, pooled: int = POOLED,
                sr: int = SAMPLING):
    """Sample positions of one axis, ``[B, N] -> [B, N, pooled * sr]``:
    (low cell, high cell, low weight, high weight, out of bounds)."""
    bins = torch.arange(pooled, dtype=torch.float32, device=start.device)
    off = (torch.arange(sr, dtype=torch.float32, device=start.device) + 0.5) / sr
    rel = (bins[:, None] + off[None, :]).reshape(-1)
    pos = start[..., None] + rel * _div(roi_len, pooled)[..., None]
    oob = (pos < -1.0) | (pos > size)
    pos = pos.clamp_min(0.0)
    low = torch.floor(pos).to(torch.int64).clamp_max(size - 1)
    pos = pos.clamp_max(size - 1)
    high = (low + 1).clamp_max(size - 1)
    frac = pos - low.to(pos.dtype)
    return low, high, 1.0 - frac, frac, oob


def box_axes(boxes: Tensor, stride: int, h: int, w: int):
    """The y and x sample axes of ``[B, N, 4]`` boxes on a level of ``h x w``."""
    x1, y1 = boxes[..., 0] / stride, boxes[..., 1] / stride
    roi_w = (boxes[..., 2] / stride - x1).clamp_min(1.0)
    roi_h = (boxes[..., 3] / stride - y1).clamp_min(1.0)
    return sample_axis(y1, roi_h, h), sample_axis(x1, roi_w, w)


def roi_align_level(fm: Tensor, boxes: Tensor, stride: int) -> Tensor:
    """``[B, N, 4]`` boxes over one ``[B, H, W, C]`` map -> ``[B, N, 7, 7, C]``."""
    bsz, h, w, _ = fm.shape
    (yl, yh, hy, ly, oob_y), (xl, xh, hx, lx, oob_x) = box_axes(boxes, stride, h, w)
    bidx = torch.arange(bsz, device=boxes.device).view(bsz, 1, 1, 1)

    def corner(yi, xi):
        return fm[bidx, yi[:, :, :, None], xi[:, :, None, :]]

    wy_l, wy_h = hy[..., :, None, None], ly[..., :, None, None]
    wx_l, wx_h = hx[..., None, :, None], lx[..., None, :, None]
    val = ((wy_l * wx_l) * corner(yl, xl) + (wy_l * wx_h) * corner(yl, xh)
           + (wy_h * wx_l) * corner(yh, xl) + (wy_h * wx_h) * corner(yh, xh))
    oob = oob_y[..., :, None] | oob_x[..., None, :]
    val = torch.where(oob[..., None], torch.zeros((), device=val.device), val)
    n = boxes.shape[1]
    return val.view(bsz, n, POOLED, SAMPLING, POOLED, SAMPLING, -1).mean(dim=(3, 5))


def multiscale_roi_align(maps: Sequence[Tensor], boxes: Tensor) -> Tensor:
    levels = fpn_level(boxes)
    out = None
    for l, (fm, stride) in enumerate(zip(maps, STRIDES)):
        pooled = roi_align_level(fm, boxes, stride)
        sel = (levels == l)[..., None, None, None]
        out = torch.where(sel, pooled, torch.zeros((), device=pooled.device) if out is None else out)
    return out

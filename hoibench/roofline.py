"""The yardstick's arithmetic: peaks of the card, byte and operation bounds
of the RoIAlign kernels, and the FLOPs of a step.

Bounds are counted from the inputs' shapes and boxes, never from a kernel:
each input byte read once, each output byte written once, and for the
forward only the distinct map cells that the samples read.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from hoibench.reference.roi_align import STRIDES, box_axes, fpn_level

# Published dense peaks at the full power limit (NVIDIA's data sheets).
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_flops=989.4e12, fp32_flops=67e12, hbm_bytes=3.35e12),
}


def peak(kind: Optional[str], what: str) -> Optional[float]:
    return PEAKS.get(kind or "", {}).get(what)


def sample_cells(boxes: torch.Tensor, hw: Sequence[tuple]):
    """Each box's level, and for each level the rows and columns (low and
    high cell, ``[..., 28]`` each) that its 14 samples a side read there."""
    per_level = []
    for (h, w), stride in zip(hw, STRIDES):
        (yl, yh, *_), (xl, xh, *_) = box_axes(boxes, stride, h, w)
        per_level.append((torch.cat([yl, yh], -1), torch.cat([xl, xh], -1)))
    return fpn_level(boxes), per_level


def roi_forward_bound_s(map_shapes: Sequence[tuple], boxes: torch.Tensor, elem: int,
                        hbm_bytes: float, fp32_flops: float) -> float:
    """Least time of the forward on these ``[B, H, W, C]`` maps and ``[B, N, 4]``
    boxes: the larger of its bytes (the distinct cells read, the boxes,
    levels and output) over HBM and its float32 operations over peak."""
    bsz, n = boxes.shape[:2]
    c = map_shapes[0][3]
    levels, per_level = sample_cells(boxes, [s[1:3] for s in map_shapes])
    cells, base = [], 0
    for l, (shape, (ys, xs)) in enumerate(zip(map_shapes, per_level)):
        h, w = shape[1:3]
        img = torch.arange(bsz, device=boxes.device)[:, None, None, None]
        ids = base + (img * h + ys[..., :, None]) * w + xs[..., None, :]
        cells.append(ids[levels == l].flatten())
        base += bsz * h * w
    touched = torch.unique(torch.cat(cells)).numel()
    n_bytes = touched * c * elem + bsz * n * 49 * c * elem + boxes.numel() * 4 + levels.numel() * 4
    flops = bsz * n * 49 * c * (4 * 4 * 2 + 2)  # 4 samples x 4 corners, then the mean
    return max(n_bytes / hbm_bytes, flops / fp32_flops)


def adjoint_bytes(map_shapes: Sequence[tuple], n_boxes: int, elem: int) -> int:
    """The adjoint's bytes: the cotangent, boxes and levels read once, the four
    map gradients written once."""
    bsz, c = map_shapes[0][0], map_shapes[0][3]
    return ((bsz * n_boxes * 49 * c + sum(b * h * w * c for b, h, w, _ in map_shapes)) * elem
            + bsz * n_boxes * (16 + 4))


def adjoint_ops(map_shapes: Sequence[tuple], boxes: torch.Tensor) -> int:
    """The adjoint's operations on these boxes: a multiply-add for each pair
    of nonzero (bin, row) and (bin, column) weights of a box on its level,
    for each channel."""
    levels = fpn_level(boxes)
    pairs = 0
    for l, ((_, h, w, _), stride) in enumerate(zip(map_shapes, STRIDES)):
        (yl, yh, wyl, wyh, oy), (xl, xh, wxl, wxh, ox) = box_axes(boxes, stride, h, w)
        ny = _nonzero_weights(yl, yh, wyl, wyh, oy, h)
        nx = _nonzero_weights(xl, xh, wxl, wxh, ox, w)
        pairs += int((ny * nx * (levels == l)).sum())
    return 2 * pairs * map_shapes[0][3]


def _nonzero_weights(low, high, w_low, w_high, oob, size) -> torch.Tensor:
    """Nonzero entries of each box's ``[7, size]`` bin-by-cell weight matrix."""
    cells = torch.arange(size, device=low.device)
    zero = torch.zeros((), device=low.device)
    w = torch.where(oob, zero, w_low)[..., None] * (cells == low[..., None])
    w = w + torch.where(oob, zero, w_high)[..., None] * (cells == high[..., None])
    return (w.unflatten(-2, (7, 2)).sum(-2) != 0).sum((-1, -2))


def adjoint_bound_s(map_shapes: Sequence[tuple], boxes: torch.Tensor, elem: int,
                    hbm_bytes: float, fp32_flops: float) -> float:
    return max(adjoint_bytes(map_shapes, boxes.shape[1], elem) / hbm_bytes,
               adjoint_ops(map_shapes, boxes) / fp32_flops)


def roi_align_share(ctx, kernel: str, bound_s: Callable, elem: int = 2) -> Optional[float]:
    """A RoIAlign kernel's share of its roofline over the traced steps, in %:
    ``bound_s(map_shapes, boxes, elem, hbm, fp32)`` of each step's maps
    (``elem`` bytes an entry; bfloat16) and boxes, summed, over the traced
    durations of ``kernel``, summed.  ``None`` without one launch a step."""
    times = ctx.trace.kernels(kernel)
    hbm, fp32 = peak(ctx.kind, "hbm_bytes"), peak(ctx.kind, "fp32_flops")
    if not times or len(times) != len(ctx.driver.traced_inputs) or hbm is None:
        return None
    bound = sum(bound_s(shapes, boxes, elem, hbm, fp32) for shapes, boxes in ctx.driver.traced_inputs)
    return bound / sum(times) * 100.0


def count_flops(fn: Callable[[], None]) -> float:
    """Convolution and matrix-product FLOPs of ``fn()`` (forward and whatever
    backward it runs), by ``FlopCounterMode``; run it on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())

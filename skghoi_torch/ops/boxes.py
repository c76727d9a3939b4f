"""Bounding-box numerics with fixed shapes.

Mirrors ``skghoi_tpu.ops.boxes``: padded boxes plus a validity mask in,
fixed-shape results out.  Boxes are ``(x1, y1, x2, y2)`` corners, the
torchvision convention.  The NMS functions take an optional leading batch
dimension, so a whole batch is filtered by one loop of N vectorised steps
that never waits on the host.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_NEG_INF = -1e30


def box_area(boxes: Tensor) -> Tensor:
    """Area of ``[..., 4]`` boxes (torchvision convention: no +1)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _iou(lt: Tensor, rb: Tensor, area1: Tensor, area2: Tensor) -> Tensor:
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)),
                       torch.zeros_like(union))


def box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU ``[..., N, 4] x [..., M, 4] -> [..., N, M]``; zero-area
    (padding) boxes give 0."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    return _iou(lt, rb, box_area(boxes1)[..., :, None], box_area(boxes2)[..., None, :])


def elementwise_box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """IoU of corresponding boxes, ``[..., 4] x [..., 4] -> [...]``."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    return _iou(lt, rb, box_area(boxes1), box_area(boxes2))


def nms_keep(boxes: Tensor, scores: Tensor, valid: Tensor, iou_threshold: float) -> Tensor:
    """Greedy NMS over padded ``[..., N, 4]`` boxes; boolean keep mask ``[..., N]``.

    torchvision semantics: boxes are visited in descending score order and a
    box is suppressed iff its IoU with an already-kept box is strictly greater
    than ``iou_threshold``.  Invalid entries are never kept and never suppress.
    The sort is stable, as ``jnp.argsort`` is, so tied scores keep index order.
    """
    n = boxes.shape[-2]
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    order = torch.argsort(-masked, dim=-1, stable=True)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    keep = torch.gather(valid, -1, order)

    suppress = box_iou(sboxes, sboxes) > iou_threshold  # [..., i, j]: i suppresses j
    earlier = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)  # i < j
    for j in range(n):
        # Is box j suppressed by any kept, higher-scoring box?
        suppressed = (keep & earlier[:, j] & suppress[..., :, j]).any(dim=-1)
        keep[..., j] &= ~suppressed
    return torch.zeros_like(keep).scatter(-1, order, keep)


def batched_nms_keep(boxes: Tensor, scores: Tensor, labels: Tensor, valid: Tensor,
                     iou_threshold: float) -> Tensor:
    """Class-wise NMS via the coordinate-offset trick; keep mask ``[..., N]``.

    Equivalent to ``torchvision.ops.batched_nms``: each class's boxes move to a
    disjoint region of the plane (per image), then plain NMS runs once.
    """
    coords = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = coords.flatten(-2).amax(dim=-1) + 1.0  # [...]
    offsets = labels.to(boxes.dtype)[..., None] * max_coord[..., None, None]
    return nms_keep(boxes + offsets, scores, valid, iou_threshold)


def resize_boxes(boxes: Tensor, original_size, new_size) -> Tensor:
    """Scale ``[..., 4]`` boxes from ``original_size`` to ``new_size``, each
    ``(h, w)`` as numbers or tensors that broadcast against ``boxes[..., 0]``
    (torchvision ``resize_boxes``; reference ``models/...models.py:62-67``)."""
    oh, ow = original_size
    nh, nw = new_size

    def t(x):
        return torch.as_tensor(x, dtype=boxes.dtype, device=boxes.device)

    ratio_w, ratio_h = t(nw) / t(ow), t(nh) / t(oh)
    return boxes * torch.stack(torch.broadcast_tensors(ratio_w, ratio_h, ratio_w, ratio_h), -1)


def hflip_boxes(boxes: Tensor, width) -> Tensor:
    """Flip ``[..., 4]`` boxes horizontally in an image of ``width``
    (``pocket.ops.horizontal_flip_boxes``; reference ``utils.py:115-118``)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([width - x2, y1, width - x1, y2], -1)

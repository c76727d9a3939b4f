"""Trainable single-stage detector on the shared ResNet50+FPN backbone.

Mirrors ``skghoi_tpu.detect.detector``: a RetinaNet-style head on P3-P5 of
the port's :class:`~skghoi_torch.models.backbone.DetectorBackbone`:

- anchors on the stride-8/16/32 levels, 3 scales x 3 ratios a cell, base
  4x the stride, in ``(h, w, anchor)`` order;
- training: per-anchor IoU matching (>=0.5 positive, <0.4 background,
  in-between ignored; the first best GT on a tie, as ``jnp.argmax``),
  alpha-balanced focal (0.25/2.0) and smooth-L1 on the standard box deltas,
  both divided by the positive count;
- inference: the best class of each anchor, a stable top-k, delta decoding,
  clipping and class-wise NMS (:func:`~skghoi_torch.ops.boxes.batched_nms_keep`).

The heads are shared across levels and run in NCHW channels_last; each
output is permuted to NHWC *before* it is flattened, so that logit ``a`` of
an image is anchor ``a`` of :func:`generate_anchors`.  Images go in as the
loader gives them (``[B, H, W, 3]`` in [0, 1], not normalised), as in JAX.
Under data parallelism the positive count is the sum over all ranks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skghoi_torch import constants as C
from skghoi_torch.detect.frcnn import top_k
from skghoi_torch.device import resolve_device
from skghoi_torch.models.backbone import DetectorBackbone
from skghoi_torch.models.layers import Conv2d
from skghoi_torch.ops.boxes import batched_nms_keep, box_iou
from skghoi_torch.ops.losses import binary_focal_loss_with_logits
from skghoi_torch.parallel.distributed import world_size
from skghoi_torch.parallel.mesh import all_reduce_sum
from skghoi_torch.weights import init_parameters

Tensor = torch.Tensor

ANCHOR_RATIOS = (0.5, 1.0, 2.0)
ANCHOR_SCALES = (1.0, 2 ** (1 / 3), 2 ** (2 / 3))
NUM_ANCHORS = len(ANCHOR_RATIOS) * len(ANCHOR_SCALES)
DET_STRIDES = (8, 16, 32)  # P3-P5 of the 4-level pyramid
CLS_PRIOR_BIAS = -4.595  # -log((1 - pi) / pi), pi = 0.01


def generate_anchors(canvas: Tuple[int, int], strides: Sequence[int] = DET_STRIDES) -> np.ndarray:
    """All anchors for a fixed canvas, ``[sum_l H_l*W_l*9, 4]`` (x1,y1,x2,y2)."""
    out = []
    for s in strides:
        h, w = canvas[0] // s, canvas[1] // s
        base = 4 * s
        ws, hs = [], []
        for r in ANCHOR_RATIOS:
            for sc in ANCHOR_SCALES:
                ws.append(base * sc * (1.0 / r) ** 0.5)
                hs.append(base * sc * r**0.5)
        ws, hs = np.asarray(ws), np.asarray(hs)
        cy, cx = np.meshgrid((np.arange(h) + 0.5) * s, (np.arange(w) + 0.5) * s, indexing="ij")
        cx, cy = cx[..., None], cy[..., None]
        boxes = np.stack([cx - ws / 2, cy - hs / 2, cx + ws / 2, cy + hs / 2], axis=-1)
        out.append(boxes.reshape(-1, 4))
    return np.concatenate(out).astype(np.float32)


def encode_deltas(anchors: Tensor, boxes: Tensor) -> Tensor:
    """Standard (dx, dy, dw, dh) parameterization."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    bw = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-3)
    bh = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-3)
    bx = boxes[..., 0] + bw / 2
    by = boxes[..., 1] + bh / 2
    return torch.stack([(bx - ax) / aw, (by - ay) / ah, torch.log(bw / aw), torch.log(bh / ah)],
                       dim=-1)


def decode_deltas(anchors: Tensor, deltas: Tensor) -> Tensor:
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    bx = deltas[..., 0] * aw + ax
    by = deltas[..., 1] * ah + ay
    bw = torch.exp(deltas[..., 2].clamp(-4.0, 4.0)) * aw
    bh = torch.exp(deltas[..., 3].clamp(-4.0, 4.0)) * ah
    return torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2], dim=-1)


class FPNDetector(nn.Module):
    """Backbone + shared cls/box subnets over the detection levels, on
    ``device`` (default ``cuda``; the CPU only when asked for).

    Module names follow the JAX tree (``cls0..3``, ``box0..3``, ``cls_out``,
    ``box_out``), so ``weights.to_state_dict`` is a walk.  Seeded
    LeCun-normal kernels and zero biases (``weights.init_parameters``), the
    class bias at the focal prior."""

    def __init__(self, num_classes: int = C.HICO_NUM_OBJECTS,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes = num_classes
        self.backbone = DetectorBackbone(device="cpu")  # seeded here, then moved
        for i in range(4):
            setattr(self, f"cls{i}", Conv2d(256, 256, 3, padding=1))
            setattr(self, f"box{i}", Conv2d(256, 256, 3, padding=1))
        self.cls_out = Conv2d(256, NUM_ANCHORS * num_classes, 3, padding=1)
        self.box_out = Conv2d(256, NUM_ANCHORS * 4, 3, padding=1)
        init_parameters(self, 0)
        with torch.no_grad():
            self.cls_out.bias.fill_(CLS_PRIOR_BIAS)
        self.to(device=device, memory_format=torch.channels_last)

    def _subnet(self, x: Tensor, name: str, out: nn.Module, width: int) -> Tensor:
        for i in range(4):
            x = F.relu(getattr(self, f"{name}{i}")(x))
        y = out(x)  # [B, 9*width, h, w]
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, width)  # (h, w, anchor) order

    def forward(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        """``[B, H, W, 3]`` -> (cls_logits ``[B, A, K]``, box_deltas
        ``[B, A, 4]``)."""
        logits, deltas = [], []
        for f in self.backbone(images)[1:]:  # P3-P5
            x = f.permute(0, 3, 1, 2)
            logits.append(self._subnet(x, "cls", self.cls_out, self.num_classes))
            deltas.append(self._subnet(x, "box", self.box_out, 4))
        return torch.cat(logits, 1), torch.cat(deltas, 1)


def match_anchors(anchors: Tensor, gt_boxes: Tensor, gt_labels: Tensor, gt_valid: Tensor,
                  pos_iou: float = 0.5, neg_iou: float = 0.4) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-anchor targets, batched over images (``gt_*`` ``[B, G, ...]``).

    Returns (cls_target ``[B, A, K]`` one-hot, box_target ``[B, A, 4]``
    deltas, anchor_state ``[B, A]``: 1 positive, 0 background, -1 ignored)."""
    iou = box_iou(anchors, gt_boxes)  # [B, A, G]
    iou = torch.where(gt_valid[:, None, :], iou, torch.zeros((), dtype=iou.dtype,
                                                             device=iou.device))
    best = iou.amax(dim=2)
    best_idx = iou.argmax(dim=2)  # the first maximum, as jnp.argmax
    pos, neg = best >= pos_iou, best < neg_iou
    state = torch.where(pos, 1, torch.where(neg, 0, -1))
    labels = torch.gather(gt_labels, 1, best_idx)
    cls_t = F.one_hot(labels.long(), C.HICO_NUM_OBJECTS).to(iou.dtype) * pos[..., None]
    matched = torch.gather(gt_boxes, 1, best_idx[..., None].expand(*best_idx.shape, 4))
    return cls_t, encode_deltas(anchors, matched), state


def detector_loss(logits: Tensor, deltas: Tensor, anchors: Tensor, gt_boxes: Tensor,
                  gt_labels: Tensor, gt_valid: Tensor) -> dict:
    """Batched focal + smooth-L1 losses, divided by the positive count.

    Under data parallelism the count is the sum over the ranks, and each
    rank's losses are its local sums x world size / that count, so that the
    ranks' mean is the whole batch's loss."""
    cls_t, box_t, state = match_anchors(anchors, gt_boxes, gt_labels, gt_valid)
    valid = state >= 0
    pos = state == 1
    n_pos = all_reduce_sum(pos.sum().to(logits.dtype)).clamp_min(1.0) / world_size()
    cls_loss = binary_focal_loss_with_logits(logits, cls_t, alpha=0.25, gamma=2.0,
                                             reduction="sum", mask=valid[..., None]) / n_pos
    diff = (deltas - box_t).abs()
    smooth = torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5)
    box_loss = (smooth * pos[..., None]).sum() / n_pos
    return dict(cls_loss=cls_loss, box_loss=box_loss)


class Detections(NamedTuple):
    boxes: Tensor  # [B, M, 4]
    labels: Tensor  # [B, M]
    scores: Tensor  # [B, M]
    valid: Tensor  # [B, M]


@torch.no_grad()
def decode_candidates(logits: Tensor, deltas: Tensor, anchors: Tensor, canvas: Tuple[int, int],
                      pre_nms_topk: int = 1000) -> Tuple[Tensor, Tensor, Tensor]:
    """The pool NMS selects from: the best class of each anchor, the
    ``pre_nms_topk`` best anchors (a stable sort, as ``jax.lax.top_k``),
    decoded and clipped to the canvas -> (boxes, scores, labels)."""
    scores_all = torch.sigmoid(logits)
    best_score, best_cls = scores_all.amax(dim=2), scores_all.argmax(dim=2)
    top_score, top_idx = top_k(best_score, pre_nms_topk)
    boxes = decode_deltas(anchors[top_idx], torch.gather(
        deltas, 1, top_idx[..., None].expand(*top_idx.shape, 4)))
    boxes = torch.stack([boxes[..., 0].clamp(0, canvas[1]), boxes[..., 1].clamp(0, canvas[0]),
                         boxes[..., 2].clamp(0, canvas[1]), boxes[..., 3].clamp(0, canvas[0])], -1)
    return boxes, top_score, torch.gather(best_cls, 1, top_idx)


@torch.no_grad()
def decode_detections(logits: Tensor, deltas: Tensor, anchors: Tensor, canvas: Tuple[int, int],
                      score_thresh: float = 0.05, nms_thresh: float = 0.5, max_out: int = 100,
                      pre_nms_topk: int = 1000) -> Detections:
    """Inference decoding, batched: :func:`decode_candidates`, class-wise
    NMS (one step a candidate), then the kept entries first by score (a
    stable sort, as ``jnp.argsort``)."""
    boxes, scores, labels = decode_candidates(logits, deltas, anchors, canvas, pre_nms_topk)
    keep = batched_nms_keep(boxes, scores, labels, scores >= score_thresh, nms_thresh)
    key = torch.where(keep, scores, torch.full_like(scores, -1.0))
    order = torch.argsort(-key, dim=1, stable=True)[:, :max_out]
    take = lambda x: torch.gather(x, 1, order)  # noqa: E731
    return Detections(torch.gather(boxes, 1, order[..., None].expand(*order.shape, 4)),
                      take(labels), take(scores), take(keep))

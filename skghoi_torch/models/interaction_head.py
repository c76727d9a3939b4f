"""Interaction head: detection filtering, RoI pooling, pair classification.

Mirrors the inference path of ``skghoi_tpu.models.interaction_head``:

- :func:`filter_detections` — the reference ``preprocess``
  (``heads/adamixer_transH_spatial_r50_head.py:92-151``): score threshold,
  class-wise NMS, score-sorted, capped at 15 humans + 15 objects with humans
  packed first, into fixed ``[B, 30]`` slots.  Batched, no host sync.
- :class:`InteractionHead` — multi-scale RoIAlign (the CUDA kernel on the
  card), GraphHead, pair predictor/suppressor, and the composite score
  ``sigmoid(logit_p) * prior_h * prior_o * sigmoid(logit_s)``.

The losses belong to training and are not here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from skghoi_torch import constants as C
from skghoi_torch.models.graph_head import GraphHead
from skghoi_torch.models.layers import Linear
from skghoi_torch.ops.boxes import batched_nms_keep
from skghoi_torch.ops.roi_align_cuda import roi_align_auto

Tensor = torch.Tensor

_NEG_INF = -1e30


class FilteredDetections(NamedTuple):
    boxes: Tensor  # [B, N, 4]
    labels: Tensor  # [B, N]
    scores: Tensor  # [B, N]
    n_h: Tensor  # [B]
    n: Tensor  # [B]


class InteractionOutputs(NamedTuple):
    scores: Tensor  # [B, H, N, K] final action scores
    logits_p: Tensor  # [B, H, N, K]
    weights: Tensor  # [B, H, N] sigmoid suppressor
    prior: Tensor  # [B, 2, H, N, K]
    pair_valid: Tensor  # [B, H, N]
    boxes: Tensor  # [B, N, 4] filtered detections (resized image space)
    object_class: Tensor  # [B, N]
    n_h: Tensor
    n: Tensor


def filter_detections(boxes: Tensor, labels: Tensor, scores: Tensor, valid: Tensor,
                      human_idx: int = C.HICO_HUMAN_IDX,
                      box_score_thresh: float = C.BOX_SCORE_THRESH,
                      box_nms_thresh: float = C.BOX_NMS_THRESH,
                      max_human: int = C.MAX_HUMAN,
                      max_object: int = C.MAX_OBJECT) -> FilteredDetections:
    """Batched detection filter ``[B, M] -> [B, max_human + max_object]``."""
    n_slots = max_human + max_object
    valid = valid & (scores >= box_score_thresh)
    keep = batched_nms_keep(boxes, scores, labels, valid, box_nms_thresh)

    order = torch.argsort(-torch.where(keep, scores, torch.full_like(scores, _NEG_INF)),
                          dim=-1, stable=True)
    s_boxes = torch.gather(boxes, 1, order[..., None].expand(*order.shape, 4))
    s_labels = torch.gather(labels, 1, order)
    s_scores = torch.gather(scores, 1, order)
    s_keep = torch.gather(keep, 1, order)

    is_h = s_keep & (s_labels == human_idx)
    is_o = s_keep & (s_labels != human_idx)
    h_rank = torch.cumsum(is_h, dim=1)  # 1-based among humans, in score order
    o_rank = torch.cumsum(is_o, dim=1)
    n_h = h_rank[:, -1].clamp_max(max_human)
    n = n_h + o_rank[:, -1].clamp_max(max_object)

    # Humans pack into slots [0, n_h), objects into [n_h, n); everything else
    # goes to an extra slot that is dropped.
    slot = torch.where(
        is_h & (h_rank <= max_human),
        h_rank - 1,
        torch.where(is_o & (o_rank <= max_object), n_h[:, None] + o_rank - 1,
                    torch.full_like(h_rank, n_slots)),
    )

    def pack(x: Tensor) -> Tensor:
        idx = slot.view(*slot.shape, *([1] * (x.dim() - 2))).expand_as(x)
        out = x.new_zeros((x.shape[0], n_slots + 1, *x.shape[2:]))
        return out.scatter(1, idx, x)[:, :n_slots].contiguous()

    return FilteredDetections(pack(s_boxes), pack(s_labels), pack(s_scores), n_h, n)


class InteractionHead(nn.Module):
    def __init__(self, num_cls: int = C.HICO_NUM_VERBS, human_idx: int = C.HICO_HUMAN_IDX,
                 num_object: int = C.HICO_NUM_OBJECTS,
                 representation_size: int = C.REPRESENTATION_SIZE,
                 num_iter: int = C.NUM_MP_ITERATIONS, max_humans: int = C.MAX_HUMAN,
                 feedback: bool = False, quirk_box_index_tails: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.box_pair_head = GraphHead(
            representation_size=representation_size, num_cls=num_cls, human_idx=human_idx,
            num_object=num_object, num_iter=num_iter, max_humans=max_humans,
            feedback=feedback, quirk_box_index_tails=quirk_box_index_tails, dtype=dtype,
        )
        # models/...models.py:176-177
        self.box_pair_predictor = Linear(2 * representation_size, num_cls, dtype=dtype)
        self.box_pair_suppressor = Linear(2 * representation_size, 1, dtype=dtype)

    def forward(self, fpn_features, detections: FilteredDetections, image_sizes: Tensor,
                object_verb_mask: Tensor) -> InteractionOutputs:
        boxes, obj_labels, obj_scores, n_h, n = detections

        box_features = roi_align_auto(fpn_features, boxes)  # [B, N, 7, 7, C]
        # Global context: average-pool the coarsest level (ref :811).
        global_features = fpn_features[3].mean(dim=(1, 2))

        gh = self.box_pair_head(global_features, box_features, boxes, obj_labels, obj_scores,
                                n_h, n, image_sizes, object_verb_mask)

        logits_p = self.box_pair_predictor(gh.pair_features)  # [B, H, N, K]
        weights = torch.sigmoid(self.box_pair_suppressor(gh.pair_features)[..., 0])  # [B, H, N]
        # Final action score (ref :315-316), on nonzero-prior entries only.
        scores = torch.sigmoid(logits_p) * (gh.prior[:, 0] * gh.prior[:, 1]) * weights[..., None]
        scores = torch.where(gh.prior[:, 0] > 0, scores, torch.zeros((), device=scores.device))

        return InteractionOutputs(scores, logits_p, weights, gh.prior, gh.pair_valid, boxes,
                                  obj_labels, n_h, n)

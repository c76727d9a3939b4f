"""Interaction head: detection filtering, RoI pooling, classification, losses.

Mirrors ``skghoi_tpu.models.interaction_head``:

- :func:`filter_detections` — the reference ``preprocess``
  (``heads/adamixer_transH_spatial_r50_head.py:92-151``): score threshold,
  class-wise NMS, score-sorted, capped at 15 humans + 15 objects with humans
  packed first, into fixed ``[B, 30]`` slots.  Batched, no host sync.  In
  training the ground-truth boxes join the pool ahead of the detections at
  score 1.0.
- :class:`InteractionHead` — multi-scale RoIAlign (the CUDA kernel and its
  adjoint on the card), GraphHead, pair predictor/suppressor, the composite
  score ``sigmoid(logit_p) * prior_h * prior_o * detach(sigmoid(logit_s))``
  and, in training, the three losses (ref ``:153-235``): focal (gamma 0.2) on
  the composite scores over nonzero-prior entries, focal interactiveness
  (gamma 2.0) on the suppressor over valid pairs, and TransH margin ranking,
  each over its positive count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from skghoi_torch import constants as C
from skghoi_torch.data.structures import HOITargets
from skghoi_torch.models.graph_head import GraphHead, GraphHeadOutputs
from skghoi_torch.models.layers import Linear
from skghoi_torch.ops.boxes import batched_nms_keep
from skghoi_torch.ops.losses import (
    binary_focal_loss,
    binary_focal_loss_with_logits,
    margin_ranking_loss,
)
from skghoi_torch.ops.roi_align_cuda import roi_align_auto
from skghoi_torch.parallel.distributed import world_size
from skghoi_torch.parallel.mesh import all_reduce_sum
from skghoi_torch.utils.profiling import span

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
    labels: Optional[Tensor] = None  # [B, H, N, K], with targets only
    unary_labels: Optional[Tensor] = None  # [B, H, N]
    losses: Optional[dict] = None  # hoi_loss, interactiveness_loss, transh_loss (training)
    metrics: Optional[dict] = None  # transh_pos_dropped (training)


def filter_detections(boxes: Tensor, labels: Tensor, scores: Tensor, valid: Tensor,
                      human_idx: int = C.HICO_HUMAN_IDX,
                      box_score_thresh: float = C.BOX_SCORE_THRESH,
                      box_nms_thresh: float = C.BOX_NMS_THRESH,
                      max_human: int = C.MAX_HUMAN,
                      max_object: int = C.MAX_OBJECT,
                      targets: Optional[HOITargets] = None) -> FilteredDetections:
    """Batched detection filter ``[B, M] -> [B, max_human + max_object]``.

    With ``targets``, the ground-truth human and object boxes go ahead of the
    detections with score 1.0 (training, ref ``:104-116``), so they survive
    the threshold and sort to the front."""
    with span("filter"):
        n_slots = max_human + max_object
        if targets is not None:
            gt_scores = targets.valid.to(scores.dtype)
            boxes = torch.cat([targets.boxes_h, targets.boxes_o, boxes], dim=1)
            scores = torch.cat([gt_scores, gt_scores, scores], dim=1)
            labels = torch.cat([torch.full_like(targets.object, human_idx).to(labels.dtype),
                                targets.object.to(labels.dtype), labels], dim=1)
            valid = torch.cat([targets.valid, targets.valid, valid], dim=1)
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
                object_verb_mask: Tensor, targets: Optional[HOITargets] = None, *,
                training: bool = False, generator: Optional[torch.Generator] = None,
                gumbel: Optional[Tensor] = None) -> InteractionOutputs:
        boxes, obj_labels, obj_scores, n_h, n = detections

        box_features = roi_align_auto(fpn_features, boxes)  # [B, N, 7, 7, C]
        # Global context: average-pool the coarsest level (ref :811).
        global_features = fpn_features[3].mean(dim=(1, 2))

        gh = self.box_pair_head(global_features, box_features, boxes, obj_labels, obj_scores,
                                n_h, n, image_sizes, object_verb_mask, targets,
                                training=training, generator=generator, gumbel=gumbel)

        logits_p = self.box_pair_predictor(gh.pair_features)  # [B, H, N, K]
        logits_s = self.box_pair_suppressor(gh.pair_features)[..., 0]  # [B, H, N]
        weights = torch.sigmoid(logits_s)
        # Final action score (ref :315-316), suppressor weight detached, on
        # nonzero-prior entries only.
        scores = (torch.sigmoid(logits_p) * (gh.prior[:, 0] * gh.prior[:, 1])
                  * weights.detach()[..., None])
        valid_entries = gh.prior[:, 0] > 0
        scores = torch.where(valid_entries, scores, torch.zeros((), device=scores.device))

        losses = metrics = None
        if training and targets is not None:
            losses = self._compute_losses(scores, logits_s, gh, valid_entries)
            metrics = dict(transh_pos_dropped=gh.transh_pos_dropped)
        return InteractionOutputs(scores, logits_p, weights, gh.prior, gh.pair_valid, boxes,
                                  obj_labels, n_h, n, gh.labels, gh.unary_labels, losses, metrics)

    def _compute_losses(self, scores: Tensor, logits_s: Tensor, gh: GraphHeadOutputs,
                        valid_entries: Tensor) -> dict:
        """The three losses (ref ``:153-235``), each summed over its entries
        and divided by its positive count (at least 1).

        Under data parallelism the counts are the sums over all ranks (the
        reference all-reduces them, ``heads/...head.py:167-172``; JAX gets
        global sums from sharding), and each rank's loss is its local sum x
        world size / the global count, so that the mean of the ranks'
        gradients is the whole batch's; the TransH term's mean over its sampled
        pairs is taken over every rank's pairs as well."""
        counts = all_reduce_sum(torch.stack([
            (gh.labels * valid_entries).sum(), (gh.unary_labels * gh.pair_valid).sum(),
            gh.transh_mask.to(gh.labels.dtype).sum()]))
        n_p_cls, n_p_unary = (counts[:2].clamp_min(1.0) / world_size()).unbind()
        hoi_loss = binary_focal_loss(scores, gh.labels, gamma=C.FOCAL_GAMMA_HOI,
                                     reduction="sum", mask=valid_entries) / n_p_cls
        interactiveness_loss = binary_focal_loss_with_logits(
            logits_s, gh.unary_labels, gamma=C.FOCAL_GAMMA_INTERACTIVENESS, reduction="sum",
            mask=gh.pair_valid) / n_p_unary
        # The margin ranking loss is a mean over the sampled pairs: over all
        # ranks' pairs too.
        transh_loss = margin_ranking_loss(gh.transh_pos, gh.transh_neg, margin=C.TRANSH_MARGIN,
                                          mask=gh.transh_mask, count=counts[2]) / n_p_unary
        return dict(hoi_loss=hoi_loss, interactiveness_loss=interactiveness_loss,
                    transh_loss=transh_loss)

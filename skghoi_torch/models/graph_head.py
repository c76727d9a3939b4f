"""Spatially-conditioned graph head over fixed padded pair grids.

Mirrors ``skghoi_tpu.models.graph_head.GraphHead``
(the reference GraphHead, ``heads/adamixer_transH_spatial_r50_head.py:586-996``,
batched onto dense ``[B, H, N, ...]`` tensors with validity masks):

- node encodings: 2-layer MLP over the pooled 7x7xC RoI features;
- TransH entity augmentation (persistent submodule): ``fc_head``/``fc_tail``
  over ``[node ; entity]``; tails are object classes, or box slot indices
  under ``quirk_box_index_tails`` (the reference's quirk);
- 46-d spatial encodings -> 46->128->256->1024 MLP;
- adjacency + MBF message passing with LayerNorm.  The reference never feeds
  updated nodes back, so with ``feedback=False`` one pass computes its fixed
  point; ``feedback=True`` iterates ``num_iter`` times;
- pair features ``[attention_head(h||o, spatial), attention_head_g(global,
  spatial)]`` and object->verb priors (exponent 1.0 in training, 2.8 at
  inference);
- with targets: GT association by pairwise min-IoU >= 0.5 (ref ``:703-719``)
  and balanced positive/negative TransH (pair, verb) sampling (ref
  ``:933-963``): positives by a stable descending sort of the 0/1 labels
  (lower index first among ties, as ``jax.lax.top_k``), negatives by the
  same sort of Gumbel noise.  The noise is an argument (``gumbel``,
  ``[B, H*N*K]``) or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from skghoi_torch import constants as C
from skghoi_torch.kge.models import TransH
from skghoi_torch.models.layers import Linear
from skghoi_torch.models.mbf import MultiBranchFusion
from skghoi_torch.ops.boxes import box_iou
from skghoi_torch.ops.spatial import compute_spatial_ratio_encodings

Tensor = torch.Tensor


class GraphHeadOutputs(NamedTuple):
    pair_features: Tensor  # [B, H, N, 2 * rep]
    pair_valid: Tensor  # [B, H, N] bool (i < n_h, j < n, i != j)
    prior: Tensor  # [B, 2, H, N, K]
    labels: Optional[Tensor] = None  # [B, H, N, K] binary, with targets only
    unary_labels: Optional[Tensor] = None  # [B, H, N]
    transh_pos: Optional[Tensor] = None  # [B, cap] distance scores of positives
    transh_neg: Optional[Tensor] = None  # [B, cap]
    transh_mask: Optional[Tensor] = None  # [B, cap] bool
    transh_pos_dropped: Optional[Tensor] = None  # positives beyond the cap, summed


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> Tensor:
    """``-log(-log(U))`` with ``U`` uniform in ``[tiny, 1)``, as
    ``jax.random.gumbel`` draws it (from other bits)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def _top_indices(x: Tensor, k: int) -> Tensor:
    """Indices of the ``k`` largest entries of each row, ties to the lower
    index (``jax.lax.top_k``'s order, on every device)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def masked_softmax(logits: Tensor, mask: Tensor, dim: int) -> Tensor:
    """Softmax that yields exact zeros on fully-masked rows (no NaNs)."""
    neg = torch.finfo(logits.dtype).min
    z = torch.where(mask, logits, torch.full_like(logits, neg))
    z = z - z.amax(dim=dim, keepdim=True).detach()
    e = torch.exp(z) * mask.to(logits.dtype)
    return e / e.sum(dim=dim, keepdim=True).clamp_min(1e-20)


def _layer_norm(norm: nn.LayerNorm, x: Tensor) -> Tensor:
    """LayerNorm in float32, returning float32 (flax promotes to its params)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


class GraphHead(nn.Module):
    def __init__(self, out_channels: int = C.FPN_CHANNELS, roi_pool_size: int = C.ROI_POOL_SIZE,
                 node_encoding_size: int = C.NODE_ENCODING_SIZE,
                 representation_size: int = C.REPRESENTATION_SIZE,
                 num_cls: int = C.HICO_NUM_VERBS, human_idx: int = C.HICO_HUMAN_IDX,
                 num_object: int = C.HICO_NUM_OBJECTS, num_iter: int = C.NUM_MP_ITERATIONS,
                 max_humans: int = C.MAX_HUMAN, transh_dim: int = C.TRANSH_DIM,
                 feedback: bool = False, quirk_box_index_tails: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ns, rep, card = node_encoding_size, representation_size, C.MBF_CARDINALITY
        self.num_cls = num_cls
        self.max_transh_pairs = C.MAX_TRANSH_PAIRS
        self.human_idx = human_idx
        self.num_object = num_object
        self.num_iter = num_iter
        self.max_humans = max_humans
        self.feedback = feedback
        self.quirk_box_index_tails = quirk_box_index_tails
        lin = lambda i, o: Linear(i, o, dtype=dtype)  # noqa: E731
        self.box_head_fc1 = lin(out_channels * roi_pool_size ** 2, ns)
        self.box_head_fc2 = lin(ns, ns)
        self.adjacency = lin(rep, 1)
        # MessageMBF: no outer ReLU — the reference applies ReLU only after the
        # adjacency-softmax weighting (ref :509-527 vs :909-922).
        self.sub_to_obj = MultiBranchFusion(ns, 1024, rep, card, final_relu=False, dtype=dtype)
        self.obj_to_sub = MultiBranchFusion(ns, 1024, rep, card, final_relu=False, dtype=dtype)
        self.norm_h = nn.LayerNorm(rep, eps=1e-5)
        self.norm_o = nn.LayerNorm(rep, eps=1e-5)
        self.spatial_fc1 = lin(C.SPATIAL_FEATURE_SIZE, C.SPATIAL_HIDDEN[0])
        self.spatial_fc2 = lin(C.SPATIAL_HIDDEN[0], C.SPATIAL_HIDDEN[1])
        self.spatial_fc3 = lin(C.SPATIAL_HIDDEN[1], C.SPATIAL_HIDDEN[2])
        self.attention_head = MultiBranchFusion(ns * 2, 1024, rep, card, dtype=dtype)
        self.attention_head_g = MultiBranchFusion(out_channels, 1024, rep, card, dtype=dtype)
        self.transh = TransH(num_object, num_cls, dim=transh_dim, p_norm=C.TRANSH_P_NORM,
                             norm_flag=C.TRANSH_NORM_FLAG)
        self.fc_head = lin(ns + transh_dim, ns)
        self.fc_tail = lin(ns + transh_dim, ns)

    def _spatial_mlp(self, x: Tensor) -> Tensor:
        x = F.relu(self.spatial_fc1(x))
        x = F.relu(self.spatial_fc2(x))
        return F.relu(self.spatial_fc3(x))

    def _box_mlp(self, x: Tensor) -> Tensor:
        x = x.flatten(-3)  # [..., 7, 7, C] -> [..., 7*7*C], channel-minor
        return F.relu(self.box_head_fc2(F.relu(self.box_head_fc1(x))))

    def compute_prior_scores(self, scores: Tensor, labels: Tensor, object_verb_mask: Tensor,
                             training: bool = False) -> Tensor:
        """``[B, 2, H, N, K]`` priors (ref ``:721-767``)."""
        h = self.max_humans
        s = scores ** (C.PRIOR_POWER_TRAIN if training else C.PRIOR_POWER_EVAL)
        valid_verbs = object_verb_mask[labels]  # [B, N, K]
        prior_h = s[:, :h, None, None] * valid_verbs[:, None, :, :]
        prior_o = s[:, None, :, None] * valid_verbs[:, None, :, :]
        return torch.stack(torch.broadcast_tensors(prior_h, prior_o), dim=1)

    def associate_with_ground_truth(self, boxes: Tensor, targets) -> Tensor:
        """``[B, H, N, K]`` binary labels: a pair takes a GT pair's verb when
        both its boxes overlap the GT's at IoU >= 0.5 (ref ``:703-719``)."""
        iou_h = box_iou(boxes[:, :self.max_humans], targets.boxes_h)  # [B, H, G]
        iou_o = box_iou(boxes, targets.boxes_o)  # [B, N, G]
        pair_hit = ((torch.minimum(iou_h[:, :, None, :], iou_o[:, None, :, :]) >= C.FG_IOU_THRESH)
                    & targets.valid[:, None, None, :])  # [B, H, N, G]
        verbs = F.one_hot(targets.labels, self.num_cls).float()  # [B, G, K]
        return torch.einsum("bhng,bgk->bhnk", pair_hit.float(), verbs).clamp(0.0, 1.0)

    def _tails(self, labels: Tensor) -> Tensor:
        """TransH tail entity of each box: its object class, or its slot
        index under the reference quirk."""
        b, n = labels.shape
        if self.quirk_box_index_tails:
            tails = torch.arange(n, device=labels.device).expand(b, n)
        else:
            tails = labels
        return tails.clamp(0, self.num_object - 1)

    def _entity_embeddings(self, labels: Tensor):
        """TransH entity of the human class and of each box's tail."""
        emb = self.transh.ent_embeddings
        return emb.weight[self.human_idx], emb(self._tails(labels))  # [dim], [B, N, dim]

    def _transh_box_scores(self, labels: Tensor) -> Tensor:
        """``[B, N, K]`` TransH distance of (human, verb k, tail of box j):
        it depends on the box and the verb only (ref ``:933-963``)."""
        tails = self._tails(labels)[..., None].expand(-1, -1, self.num_cls)
        heads = torch.full_like(tails, self.human_idx)
        rels = torch.arange(self.num_cls, device=labels.device).expand_as(tails)
        return self.transh.score(heads, tails, rels)

    def _sample_transh_pairs(self, gumbel: Tensor, transh_pair: Tensor, labels: Tensor,
                             pair_valid: Tensor):
        """Balanced positive/negative (pair, verb) selection: up to ``cap``
        labelled entries and as many valid unlabelled ones at random (the
        batched form of ref ``:936-943``'s nonzero + randperm)."""
        b = transh_pair.shape[0]
        cap = self.max_transh_pairs
        flat_scores = transh_pair.reshape(b, -1)
        flat_labels = (labels * pair_valid[..., None]).reshape(b, -1)
        pv = pair_valid[..., None].expand_as(labels).reshape(b, -1)
        neg_ok = (flat_labels < 0.5) & pv

        n_labelled = flat_labels.sum(dim=1)
        pos_idx = _top_indices(flat_labels, cap)
        pos_mask = torch.arange(cap, device=labels.device)[None, :] < n_labelled.clamp_max(cap)[:, None]
        neg_logits = torch.where(neg_ok, gumbel, torch.full_like(gumbel, -float("inf")))
        neg_idx = _top_indices(neg_logits, cap)

        pos = torch.gather(flat_scores, 1, pos_idx)
        neg = torch.gather(flat_scores, 1, neg_idx)
        dropped = (n_labelled - cap).clamp_min(0.0).sum()
        return pos, neg, pos_mask, dropped

    def forward(self, global_features: Tensor, box_features: Tensor, boxes: Tensor,
                labels: Tensor, scores: Tensor, n_h: Tensor, n: Tensor,
                image_sizes: Tensor, object_verb_mask: Tensor, targets=None, *,
                training: bool = False, generator: Optional[torch.Generator] = None,
                gumbel: Optional[Tensor] = None) -> GraphHeadOutputs:
        b, n_slots = boxes.shape[:2]
        h = self.max_humans

        node_enc = self._box_mlp(box_features)  # [B, N, ns]

        # --- TransH augmentation (float32 entities, as flax promotes) --------
        head_embed, tail_embed = self._entity_embeddings(labels)
        node32 = node_enc.float()
        h_aug = F.relu(self.fc_head(
            torch.cat([node32[:, :h], head_embed.expand(b, h, -1)], dim=-1)))  # [B, H, ns]
        o_aug = F.relu(self.fc_tail(torch.cat([node32, tail_embed], dim=-1)))  # [B, N, ns]

        # --- spatial encodings over the full H x N pair grid -----------------
        spatial_raw = compute_spatial_ratio_encodings(
            boxes[:, :h, None, :], boxes[:, None, :, :],
            image_sizes[:, 0, None, None], image_sizes[:, 1, None, None],
        )  # [B, H, N, 46]
        spatial = self._spatial_mlp(spatial_raw)  # [B, H, N, 1024]

        # --- masks ------------------------------------------------------------
        dev = boxes.device
        human_ok = torch.arange(h, device=dev)[None, :] < n_h.clamp_max(h)[:, None]  # [B, H]
        box_ok = torch.arange(n_slots, device=dev)[None, :] < n[:, None]  # [B, N]
        not_self = torch.arange(h, device=dev)[:, None] != torch.arange(n_slots, device=dev)[None, :]
        pair_valid = human_ok[:, :, None] & box_ok[:, None, :] & not_self  # i == j removed (ref :852)

        # --- message passing ---------------------------------------------------
        cur_h, cur_o = h_aug, o_aug
        for _ in range(self.num_iter if self.feedback else 1):
            app = torch.cat(torch.broadcast_tensors(cur_h[:, :, None, :], cur_o[:, None, :, :]), -1)
            adj = self.adjacency(self.attention_head(app, spatial))[..., 0]  # [B, H, N]

            # Messages to humans: softmax over objects j (ref :909-914).
            w_row = masked_softmax(adj, box_ok[:, None, :], dim=2)
            o_t_s = self.obj_to_sub(cur_o[:, None, :, :], spatial)  # [B, H, N, rep]
            msg_h = F.relu((w_row[..., None] * o_t_s).sum(dim=2))
            new_h = _layer_norm(self.norm_h, (cur_h if self.feedback else h_aug) + msg_h)

            # Messages to objects: softmax of adj^T over humans i (ref :916-925).
            w_col = masked_softmax(adj.transpose(1, 2), human_ok[:, None, :], dim=2)  # [B, N, H]
            s_t_o = self.sub_to_obj(cur_h[:, :, None, :], spatial)  # [B, H, N, rep]
            msg_o = F.relu((w_col.transpose(1, 2)[..., None] * s_t_o).sum(dim=1))  # [B, N, rep]
            new_o = _layer_norm(self.norm_o, (cur_o if self.feedback else o_aug) + msg_o)

            cur_h, cur_o = new_h, new_o

        # --- pair features (ref :966-973) --------------------------------------
        pair_app = torch.cat(torch.broadcast_tensors(cur_h[:, :, None, :], cur_o[:, None, :, :]), -1)
        attn1 = self.attention_head(pair_app, spatial)
        attn2 = self.attention_head_g(global_features[:, None, None, :], spatial)
        pair_features = torch.cat([attn1, attn2], dim=-1)  # [B, H, N, 2*rep]

        prior = self.compute_prior_scores(scores, labels, object_verb_mask, training)
        prior = prior * pair_valid[:, None, :, :, None]
        if targets is None:
            return GraphHeadOutputs(pair_features, pair_valid, prior)

        # --- targets: labels and TransH samples (ref :933-963) ----------------
        gt_labels = self.associate_with_ground_truth(boxes, targets) * pair_valid[..., None]
        unary = gt_labels.sum(dim=-1).clamp(0.0, 1.0)
        k = self.num_cls
        transh_pair = self._transh_box_scores(labels)[:, None].expand(b, h, n_slots, k)
        if gumbel is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            gumbel = gumbel_noise((b, h * n_slots * k), generator, dev)
        pos, neg, mask, dropped = self._sample_transh_pairs(gumbel, transh_pair, gt_labels,
                                                            pair_valid)
        return GraphHeadOutputs(pair_features, pair_valid, prior, gt_labels, unary, pos, neg, mask,
                                dropped)

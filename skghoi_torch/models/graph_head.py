"""Spatially-conditioned graph head over fixed padded pair grids (eval path).

Mirrors the inference path of ``skghoi_tpu.models.graph_head.GraphHead``
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
  spatial)]`` and object->verb priors with the eval exponent 2.8.

GT association and TransH pair sampling belong to training and are not here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from skghoi_torch import constants as C
from skghoi_torch.kge.models import TransH
from skghoi_torch.models.layers import Linear
from skghoi_torch.models.mbf import MultiBranchFusion
from skghoi_torch.ops.spatial import compute_spatial_ratio_encodings

Tensor = torch.Tensor


class GraphHeadOutputs(NamedTuple):
    pair_features: Tensor  # [B, H, N, 2 * rep]
    pair_valid: Tensor  # [B, H, N] bool (i < n_h, j < n, i != j)
    prior: Tensor  # [B, 2, H, N, K]


def masked_softmax(logits: Tensor, mask: Tensor, dim: int) -> Tensor:
    """Softmax that yields exact zeros on fully-masked rows (no NaNs)."""
    neg = torch.finfo(logits.dtype).min
    z = torch.where(mask, logits, torch.full_like(logits, neg))
    z = z - z.amax(dim=dim, keepdim=True)
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

    def compute_prior_scores(self, scores: Tensor, labels: Tensor,
                             object_verb_mask: Tensor) -> Tensor:
        """``[B, 2, H, N, K]`` eval priors (ref ``:721-767``)."""
        h = self.max_humans
        s = scores ** C.PRIOR_POWER_EVAL
        valid_verbs = object_verb_mask[labels]  # [B, N, K]
        prior_h = s[:, :h, None, None] * valid_verbs[:, None, :, :]
        prior_o = s[:, None, :, None] * valid_verbs[:, None, :, :]
        return torch.stack(torch.broadcast_tensors(prior_h, prior_o), dim=1)

    def _entity_embeddings(self, labels: Tensor):
        """TransH entity of the human class and of each box's tail."""
        b, n = labels.shape
        if self.quirk_box_index_tails:
            tails = torch.arange(n, device=labels.device).expand(b, n)
        else:
            tails = labels
        tails = tails.clamp(0, self.num_object - 1)
        emb = self.transh.ent_embeddings
        return emb.weight[self.human_idx], emb(tails)  # [dim], [B, N, dim]

    def forward(self, global_features: Tensor, box_features: Tensor, boxes: Tensor,
                labels: Tensor, scores: Tensor, n_h: Tensor, n: Tensor,
                image_sizes: Tensor, object_verb_mask: Tensor) -> GraphHeadOutputs:
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

        prior = self.compute_prior_scores(scores, labels, object_verb_mask)
        prior = prior * pair_valid[:, None, :, :, None]
        return GraphHeadOutputs(pair_features, pair_valid, prior)

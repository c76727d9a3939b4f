"""DETR-R50: facebookresearch/detr checkpoint import and inference, plus the
HICO-DET fine-tuning pieces (head surgery, set loss).

Mirrors ``skghoi_tpu.detect.detr`` (the reference's best cached detections
come from a DETR-R50 fine-tuned on HICO-DET, ``hicodet/detections/main_detr.py``):

- the port's :class:`~skghoi_torch.models.resnet.ResNet50` body (frozen BN)
  -> C5, a 1x1 ``input_proj`` to 256;
- sine positional embeddings computed in float64 numpy and cast once;
- a 6-layer post-norm transformer encoder and decoder (8 heads, FFN 2048,
  LayerNorm eps 1e-5), 100 learned object queries, a final decoder norm;
- a class head (``num_classes + 1`` logits with the no-object slot) and a
  3-layer box MLP giving normalised cxcywh through a sigmoid.

Attention is torch ``nn.MultiheadAttention``'s packed layout
(:class:`PackedMHA`: ``in_proj_weight [3D, D]``, ``out_proj``), so
:func:`load_torch_detr` renames keys and takes the body through
:func:`~skghoi_torch.weights.load_torch_resnet50`.  Module names:
``body``, ``input_proj``, ``encoder.{i}``, ``decoder.{i}``, ``decoder_norm``,
``query_embed``, ``class_embed``, ``bbox_mlp.{i}``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skghoi_torch.detect.adamixer import _giou, _giou_terms, hungarian_match
from skghoi_torch.device import resolve_device
from skghoi_torch.models.layers import Conv2d
from skghoi_torch.models.resnet import ResNet50
from skghoi_torch.parallel.distributed import world_size
from skghoi_torch.parallel.mesh import all_reduce_sum
from skghoi_torch.weights import cpu_float32, init_parameters, load_torch_resnet50

Tensor = torch.Tensor

D_MODEL = 256
N_HEADS = 8
FFN_DIM = 2048
N_LAYERS = 6
N_QUERIES = 100
LN_EPS = 1e-5


def sine_position_embedding(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0) -> np.ndarray:
    """DETR ``PositionEmbeddingSine`` for a fully valid ``[h, w]`` grid ->
    ``[h, w, 256]`` (y-features then x-features, sin/cos interleaved),
    computed in float64 and cast to float32 once."""
    scale = 2 * math.pi
    eps = 1e-6
    y = np.arange(1, h + 1, dtype=np.float64)[:, None] / (h + eps) * scale
    x = np.arange(1, w + 1, dtype=np.float64)[None, :] / (w + eps) * scale
    y = np.broadcast_to(y, (h, w))
    x = np.broadcast_to(x, (h, w))
    dim_t = temperature ** (2 * (np.arange(num_pos_feats) // 2) / num_pos_feats)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])], axis=-1).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])], axis=-1).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1).astype(np.float32)


class PackedMHA(nn.Module):
    """torch ``nn.MultiheadAttention`` semantics with the packed qkv
    projection, written out (batch first)."""

    def __init__(self, dim: int = D_MODEL, num_heads: int = N_HEADS):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        d = q.shape[-1]
        w, b = self.in_proj_weight, self.in_proj_bias
        hd = d // self.num_heads

        def split(x):  # [B, L, D] -> [B, H, L, hd]
            return x.reshape(x.shape[0], x.shape[1], self.num_heads, hd).transpose(1, 2)

        qh = split(F.linear(q, w[:d], b[:d]))
        kh = split(F.linear(k, w[d:2 * d], b[d:2 * d]))
        vh = split(F.linear(v, w[2 * d:], b[2 * d:]))
        attn = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(hd), dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, vh)
        return self.out_proj(out.transpose(1, 2).reshape(q.shape[0], q.shape[1], d))


class EncoderLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.self_attn = PackedMHA()
        self.linear1 = nn.Linear(D_MODEL, FFN_DIM)
        self.linear2 = nn.Linear(FFN_DIM, D_MODEL)
        self.norm1 = nn.LayerNorm(D_MODEL, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(D_MODEL, eps=LN_EPS)

    def forward(self, src: Tensor, pos: Tensor) -> Tensor:
        q = src + pos
        src = self.norm1(src + self.self_attn(q, q, src))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DecoderLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.self_attn = PackedMHA()
        self.multihead_attn = PackedMHA()
        self.linear1 = nn.Linear(D_MODEL, FFN_DIM)
        self.linear2 = nn.Linear(FFN_DIM, D_MODEL)
        self.norm1 = nn.LayerNorm(D_MODEL, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(D_MODEL, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(D_MODEL, eps=LN_EPS)

    def forward(self, tgt: Tensor, memory: Tensor, pos: Tensor, query_pos: Tensor) -> Tensor:
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class DETRDetections(NamedTuple):
    boxes: Tensor  # [B, Q, 4] xyxy in image coordinates
    labels: Tensor  # [B, Q]
    scores: Tensor  # [B, Q]


class DETR(nn.Module):
    """DETR-R50 on ``device`` (default ``cuda``; the CPU only when asked
    for): images -> per-query (box, label, score); :meth:`raw` gives the
    outputs a set loss needs.  Images are ``[B, H, W, 3]``, normalised.

    Parameters are float32.  The ResNet-50 and ``input_proj`` compute in
    ``dtype``; the transformer and the heads in float32, as in JAX."""

    def __init__(self, num_classes: int = 91, num_layers: int = N_LAYERS,
                 num_queries: int = N_QUERIES, dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        device = resolve_device(device)
        self.body = ResNet50(dtype=dtype)
        self.input_proj = Conv2d(2048, D_MODEL, 1, dtype=dtype)
        self.encoder = nn.ModuleList(EncoderLayer() for _ in range(num_layers))
        self.decoder = nn.ModuleList(DecoderLayer() for _ in range(num_layers))
        self.decoder_norm = nn.LayerNorm(D_MODEL, eps=LN_EPS)
        self.query_embed = nn.Parameter(torch.zeros(num_queries, D_MODEL))
        self.class_embed = nn.Linear(D_MODEL, num_classes + 1)
        self.bbox_mlp = nn.ModuleList([nn.Linear(D_MODEL, D_MODEL), nn.Linear(D_MODEL, D_MODEL),
                                       nn.Linear(D_MODEL, 4)])
        init_parameters(self, 0)
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            self.query_embed.normal_(0.0, 1.0, generator=g)
            for m in self.modules():
                if isinstance(m, PackedMHA):
                    m.in_proj_weight.normal_(0.0, D_MODEL ** -0.5, generator=g)
        self._pos: Dict[Tuple, Tensor] = {}
        self.to(device=device, memory_format=torch.channels_last)

    def _position(self, h: int, w: int, device) -> Tensor:
        key = (h, w, str(device))
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(sine_position_embedding(h, w)).reshape(
                1, h * w, D_MODEL).to(device)
        return self._pos[key]

    def raw(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        """-> (class logits ``[B, Q, C+1]``, boxes cxcywh in [0, 1]), float32."""
        feat = self.input_proj(self.body(images.permute(0, 3, 1, 2))[-1])  # [B, 256, h, w]
        # JAX's EncoderLayer, DecoderLayer and PackedMHA take ``dtype`` but do
        # not pass it on (skghoi_tpu/detect/detr.py:95-119): ``src + pos`` and
        # the float32 projections promote the features, so the transformer
        # runs in its parameters' dtype (float32) whatever ``dtype`` is.
        feat = feat.to(self.query_embed.dtype)
        b, _, fh, fw = feat.shape
        src = feat.permute(0, 2, 3, 1).reshape(b, fh * fw, D_MODEL)
        pos = self._position(fh, fw, src.device)
        memory = src
        for layer in self.encoder:
            memory = layer(memory, pos)
        query_pos = self.query_embed[None].expand(b, -1, -1)
        tgt = torch.zeros_like(query_pos)
        for layer in self.decoder:
            tgt = layer(tgt, memory, pos, query_pos)
        hs = self.decoder_norm(tgt)
        xb = hs
        for i, layer in enumerate(self.bbox_mlp):
            xb = layer(xb)
            if i < 2:
                xb = F.relu(xb)
        return self.class_embed(hs).float(), torch.sigmoid(xb).float()

    @torch.no_grad()
    def forward(self, images: Tensor, image_sizes: Tensor) -> DETRDetections:
        """``image_sizes`` ``[B, 2]`` (h, w): the extent the normalised boxes
        scale to (``PostProcess``)."""
        logits, boxes = self.raw(images)
        probs = torch.softmax(logits, dim=-1)[..., :-1]  # drop no-object
        scores, labels = probs.amax(dim=-1), probs.argmax(dim=-1)
        cx, cy, bw, bh = boxes.unbind(-1)
        hgt, wid = image_sizes[:, None, 0].float(), image_sizes[:, None, 1].float()
        xyxy = torch.stack([(cx - bw / 2) * wid, (cy - bh / 2) * hgt,
                            (cx + bw / 2) * wid, (cy + bh / 2) * hgt], dim=-1)
        return DETRDetections(boxes=xyxy, labels=labels, scores=scores)


# --------------------------------------------------------------------------
# facebookresearch/detr state_dict -> the port's state_dict
# --------------------------------------------------------------------------

_DETR_RENAMES = (
    ("transformer.encoder.layers.", "encoder."),
    ("transformer.decoder.layers.", "decoder."),
    ("transformer.decoder.norm.", "decoder_norm."),
    ("bbox_embed.layers.", "bbox_mlp."),
    ("input_proj.", "input_proj."),
    ("class_embed.", "class_embed."),
)


def random_state_dict(seed: int = 0) -> Dict[str, Tensor]:
    """Seeded random weights in the facebookresearch/detr ``state_dict``
    layout (detr-r50: 91 classes, 6+6 layers, 100 queries), at full widths.  No DETR checkpoint is in the
    repository, so the smoke run drives the detector with these.  The body
    is :func:`skghoi_torch.detect.frcnn.random_state_dict`'s ResNet-50;
    linear layers are LeCun-normal with small biases, LayerNorms near
    identity, the queries standard normal (``nn.Embedding``'s default)."""
    from skghoi_torch.detect.frcnn import random_state_dict as frcnn_state_dict

    rng = np.random.default_rng(seed)
    sd: Dict[str, Tensor] = {"backbone.0.body." + k[len("backbone.body."):]: v
                             for k, v in frcnn_state_dict(seed).items()
                             if k.startswith("backbone.body.")}

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    def linear(name, o, i):
        sd[name + ".weight"] = t(rng.standard_normal((o, i)) / math.sqrt(i))
        sd[name + ".bias"] = t(rng.standard_normal(o) * 0.01)

    def norm(name):
        sd[name + ".weight"] = t(rng.uniform(0.9, 1.1, D_MODEL))
        sd[name + ".bias"] = t(rng.standard_normal(D_MODEL) * 0.01)

    def mha(name):
        sd[name + ".in_proj_weight"] = t(rng.standard_normal((3 * D_MODEL, D_MODEL))
                                         / math.sqrt(D_MODEL))
        sd[name + ".in_proj_bias"] = t(np.zeros(3 * D_MODEL))
        linear(name + ".out_proj", D_MODEL, D_MODEL)

    sd["input_proj.weight"] = t(rng.standard_normal((D_MODEL, 2048, 1, 1)) / math.sqrt(2048))
    sd["input_proj.bias"] = t(rng.standard_normal(D_MODEL) * 0.01)
    for kind, attns, norms in (("encoder", ("self_attn",), 2),
                               ("decoder", ("self_attn", "multihead_attn"), 3)):
        for i in range(N_LAYERS):
            p = f"transformer.{kind}.layers.{i}"
            for a in attns:
                mha(f"{p}.{a}")
            linear(f"{p}.linear1", FFN_DIM, D_MODEL)
            linear(f"{p}.linear2", D_MODEL, FFN_DIM)
            for n in range(1, norms + 1):
                norm(f"{p}.norm{n}")
    norm("transformer.decoder.norm")
    sd["query_embed.weight"] = t(rng.standard_normal((N_QUERIES, D_MODEL)))
    linear("class_embed", 92, D_MODEL)  # 91 COCO ids and no-object
    for i in range(3):
        linear(f"bbox_embed.layers.{i}", 4 if i == 2 else D_MODEL, D_MODEL)
    return sd


def load_torch_detr(state_dict: Mapping[str, Any]) -> Dict[str, Tensor]:
    """A facebookresearch/detr ``state_dict`` (detr-r50) -> the ``state_dict``
    of :class:`DETR` (float32 CPU tensors)."""
    out = {f"body.{k}": v for k, v in
           load_torch_resnet50(state_dict, prefix="backbone.0.body.").items()}
    for k, v in state_dict.items():
        for src, dst in _DETR_RENAMES:
            if k.startswith(src):
                out[dst + k[len(src):]] = cpu_float32(v)
    out["query_embed"] = cpu_float32(state_dict["query_embed.weight"])
    return out


# --------------------------------------------------------------------------
# HICO-DET fine-tuning: 81-class head surgery + set-prediction loss
# (``hicodet/detections/main_detr.py:139-196``)
# --------------------------------------------------------------------------

# COCO-91 logit rows kept by the surgery: 80 object classes + the no-object
# slot (row 91), exactly ``main_detr.py:144-151``.
DETR_SURGERY_KEEP = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90, 91,
]

# HICO-DET object index -> index in the surgered 80-class space
# (``main_detr.py:104-110``; e.g. HICO 49 "person" -> 0).
HICO_TO_DETR80 = [
    4, 47, 24, 46, 34, 35, 21, 59, 13, 1, 14, 8, 73, 39, 45, 50, 5,
    55, 2, 51, 15, 67, 56, 74, 57, 19, 41, 60, 16, 54, 20, 10, 42, 29,
    23, 78, 26, 17, 52, 66, 33, 43, 63, 68, 3, 64, 49, 69, 12, 0, 53,
    58, 72, 65, 48, 76, 18, 71, 36, 30, 31, 44, 32, 11, 28, 37, 77, 38,
    27, 70, 61, 79, 9, 6, 7, 62, 25, 75, 40, 22,
]


def hico_head_surgery(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """80-class head surgery on a COCO-pretrained DETR ``state_dict``: the
    92-row ``class_embed`` becomes the 81 kept rows (``main_detr.py:141-157``).
    The result loads with :func:`load_torch_detr` into ``DETR(num_classes=80)``."""
    sd = dict(state_dict)
    keep = torch.tensor(DETR_SURGERY_KEEP)
    for t in ("weight", "bias"):
        sd[f"class_embed.{t}"] = torch.as_tensor(sd[f"class_embed.{t}"])[keep]
    return sd


def _cxcywh_to_xyxy(b: Tensor) -> Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def detr_match_cost(logits: Tensor, boxes_cxcywh: Tensor, gt_boxes_cxcywh: Tensor,
                    gt_labels: Tensor, cls_w: float = 1.0, l1_w: float = 5.0,
                    giou_w: float = 2.0) -> Tensor:
    """DETR's Hungarian cost ``[..., Q, G]``: -p[label] + L1 + GIoU
    (``matcher.py`` semantics), batched over leading dims."""
    p = torch.softmax(logits, dim=-1)
    cols = gt_labels.long().clamp(0, logits.shape[-1] - 1)[..., None, :].expand(
        *logits.shape[:-1], gt_labels.shape[-1])
    l1 = (boxes_cxcywh[..., :, None, :] - gt_boxes_cxcywh[..., None, :, :]).abs().sum(-1)
    giou = _giou(_cxcywh_to_xyxy(boxes_cxcywh), _cxcywh_to_xyxy(gt_boxes_cxcywh))
    return -cls_w * torch.gather(p, -1, cols) + l1_w * l1 - giou_w * giou


def detr_set_loss(logits: Tensor, boxes_cxcywh: Tensor, assignments: Tensor,
                  gt_boxes_cxcywh: Tensor, gt_labels: Tensor, gt_valid: Tensor,
                  eos_coef: float = 0.1, l1_w: float = 5.0, giou_w: float = 2.0) -> dict:
    """DETR criterion: CE over all queries (no-object weighted ``eos_coef``),
    L1 + GIoU over matched pairs, both normalised by the GT count.  Under
    data parallelism the GT count and the CE's weight sum are sums over the
    ranks, each rank's terms its local sums x world size / those."""
    b, q, c1 = logits.shape
    no_object = c1 - 1
    dev = logits.device
    world = world_size()
    assignments = torch.as_tensor(assignments, device=dev).long()
    matched = (gt_valid > 0) & (assignments >= 0)
    q_idx = torch.where(matched, assignments, q)
    target = torch.full((b, q + 1), no_object, dtype=torch.long, device=dev)
    target.scatter_(1, q_idx, torch.where(matched, gt_labels.long(), no_object))
    target = target[:, :q]
    ce = -torch.gather(torch.log_softmax(logits, dim=-1), -1, target[..., None])[..., 0]
    weight = torch.where(target == no_object, eos_coef, 1.0)
    counts = all_reduce_sum(torch.stack([weight.sum(), gt_valid.sum().float()]))
    w_sum, n_gt = counts[0] / world, counts[1].clamp_min(1.0) / world
    pb = torch.gather(boxes_cxcywh, 1, assignments.clamp(0, q - 1)[..., None].expand(b, -1, 4))
    l1 = ((pb - gt_boxes_cxcywh).abs() * matched[..., None]).sum() / n_gt
    giou = _giou_terms(_cxcywh_to_xyxy(pb), _cxcywh_to_xyxy(gt_boxes_cxcywh))
    giou_loss = ((1.0 - giou) * matched).sum() / n_gt
    return dict(ce_loss=(ce * weight).sum() / w_sum, l1_loss=l1_w * l1,
                giou_loss=giou_w * giou_loss)


@torch.no_grad()
def detr_assignments(logits: Tensor, boxes_cxcywh: Tensor, gt_boxes_cxcywh: Tensor,
                     gt_labels: Tensor, gt_valid: Tensor) -> np.ndarray:
    """Host Hungarian per image -> ``[B, G]`` query indices (-1 invalid)."""
    cost = detr_match_cost(logits.float(), boxes_cxcywh.float(), gt_boxes_cxcywh.float(),
                           gt_labels).cpu().numpy()
    valid = torch.as_tensor(gt_valid).cpu().numpy().astype(bool)
    return np.stack([hungarian_match(cost[bi], valid[bi]) for bi in range(cost.shape[0])])

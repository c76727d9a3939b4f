"""AdaMixer query-based detector (decoder + set-prediction loss).

Mirrors ``skghoi_tpu.detect.adamixer`` (the reference's stage-1 family, an
AdaMixer-R50 built from an mmdet config, ``models/adamixer_transH_spatial_r50_models.py:144-157``;
AdaMixer, CVPR 2022): each query carries a content vector and an
``(x, y, z, r)`` box, and each of the decoder's stages runs

1. position-aware multi-head self-attention across queries (explicit
   query/key/value/out projections, the query scaled by ``1/sqrt(D/H)``, as
   flax's ``MultiHeadDotProductAttention`` computes it);
2. adaptive 3D sampling: ``G x P_in`` points a query at query-generated
   offsets, bilinear in space (tap indices clamped to the map) and a Gaussian
   softmax over the four pyramid levels in scale; each group reads its own
   ``C/G`` channel slice;
3. adaptive channel mixing (a per-group ``C/G x C/G`` matrix generated from
   the query) then adaptive spatial mixing (``P_out x P_in``);
4. an FFN, a class head and an ``(dx, dy, dz, dr)`` box update.

Every LayerNorm has flax's default epsilon, 1e-6.  Module names follow the
JAX tree (``stage{s}``, ``level_proj{i}``, ``self_attn.{query,key,value,out}``),
so ``weights.adamixer_state_dict`` is a walk plus the attention reshapes.

The set loss is DETR's family: the Hungarian matching of each (stage, image)
runs on the host (:func:`compute_assignments`: one batched cost on the
device, one copy, then scipy), the loss on the device.  Under data
parallelism the GT count that normalises it is the sum over all ranks.

Spans (``utils.profiling.span``, open only while a profiler records):
``decoder`` over :meth:`AdaMixerDecoder.forward`, ``sample`` over each
stage's :func:`sample_groups`, ``mixing`` over each
:meth:`AdaptiveMixing.forward` and ``match`` over
:func:`compute_assignments`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skghoi_torch import constants as C
from skghoi_torch.device import resolve_device
from skghoi_torch.models.backbone import DetectorBackbone
from skghoi_torch.ops.losses import binary_focal_loss_with_logits
from skghoi_torch.parallel.distributed import world_size
from skghoi_torch.parallel.mesh import all_reduce_sum
from skghoi_torch.utils.profiling import span
from skghoi_torch.weights import init_parameters

Tensor = torch.Tensor

LEVEL_LOGS = (2.0, 3.0, 4.0, 5.0)  # log2 of the pyramid's strides 4..32
LN_EPS = 1e-6  # flax nn.LayerNorm's default
CLS_PRIOR_BIAS = -4.595


# ---------------------------------------------------------------------------
# (x, y, z, r) boxes: z = log2(sqrt(w*h)), r = log2(h/w).
# ---------------------------------------------------------------------------

def _wh(z: Tensor, r: Tensor) -> Tuple[Tensor, Tensor]:
    return torch.exp2(z - 0.5 * r), torch.exp2(z + 0.5 * r)


def xyzr_to_box(xyzr: Tensor) -> Tensor:
    """[..., 4] (x, y, z, r) -> [..., 4] (x1, y1, x2, y2)."""
    x, y, z, r = xyzr.unbind(-1)
    w, h = _wh(z, r)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def box_to_xyzr(boxes: Tensor) -> Tensor:
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-4)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-4)
    x = (boxes[..., 0] + boxes[..., 2]) / 2
    y = (boxes[..., 1] + boxes[..., 3]) / 2
    return torch.stack([x, y, torch.log2(torch.sqrt(w * h)), torch.log2(h / w)], dim=-1)


def apply_deltas(xyzr: Tensor, deltas: Tensor) -> Tensor:
    """Refine: x/y move in units of box width/height, z/r additively."""
    x, y, z, r = xyzr.unbind(-1)
    dx, dy, dz, dr = deltas.unbind(-1)
    w, h = _wh(z, r)
    return torch.stack([x + dx * w, y + dy * h, z + dz, r + dr], dim=-1)


def position_embedding(xyzr: Tensor, dim: int, temperature: float = 10000.0) -> Tensor:
    """Sinusoidal embedding of each of the 4 query-box coordinates."""
    per = dim // 4
    freq = temperature ** (torch.arange(per // 2, dtype=xyzr.dtype, device=xyzr.device)
                           / (per // 2))
    ang = xyzr[..., :, None] / freq  # [..., 4, per/2]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return emb.reshape(*xyzr.shape[:-1], 4 * per)


# ---------------------------------------------------------------------------
# Adaptive 3D feature sampling
# ---------------------------------------------------------------------------

def _bilinear_sample(feat: Tensor, h: int, w: int, x: Tensor, y: Tensor) -> Tensor:
    """Sample one level: ``feat`` ``[B, G, H*W, c]``, ``x``/``y`` ``[B, G, M]``
    in pixel units of that level's grid (align_corners=False: pixel centres
    at +0.5) -> ``[B, G, M, c]``.  Each tap index clamps to the map (border
    padding)."""
    xf, yf = x - 0.5, y - 0.5
    x0, y0 = torch.floor(xf), torch.floor(yf)
    wx, wy = (xf - x0)[..., None], (yf - y0)[..., None]
    c = feat.shape[-1]

    def tap(ix, iy):
        idx = iy.long().clamp(0, h - 1) * w + ix.long().clamp(0, w - 1)
        return torch.gather(feat, 2, idx[..., None].expand(*idx.shape, c))

    top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _sample_grouped(levels: Sequence[Tuple[Tensor, int, int]], points: Tensor,
                    tau: float) -> Tensor:
    """``levels``: per level ``(feat [B, G, H*W, c], H, W)``; ``points``
    ``[B, G, M, 3]`` (x, y image pixels; z log2-scale) -> ``[B, G, M, c]``:
    each point group reads its own map, bilinear in space and a Gaussian
    softmax over the levels in scale."""
    xs, ys, zs = points.unbind(-1)
    logs = torch.tensor(LEVEL_LOGS, dtype=points.dtype, device=points.device)
    wts = torch.softmax(-((zs[..., None] - logs) ** 2) / tau, dim=-1)  # [B, G, M, 4]
    out = None
    for li, (feat, h, w) in enumerate(levels):
        stride = 2.0 ** LEVEL_LOGS[li]
        term = _bilinear_sample(feat, h, w, xs / stride, ys / stride) * wts[..., li:li + 1].to(
            feat.dtype)
        out = term if out is None else out + term
    return out


def sample_3d(pyramid: Sequence[Tensor], points: Tensor, tau: float = 2.0) -> Tensor:
    """``pyramid``: 4 levels ``[B, H_l, W_l, C]`` (strides 4..32); ``points``
    ``[B, N, G, P, 3]`` -> ``[B, N, G, P, C]``, every point over all channels
    (``skghoi_tpu.detect.adamixer.sample_3d``)."""
    b, n, g, p, _ = points.shape
    levels = [(f.reshape(b, 1, -1, f.shape[-1]), f.shape[1], f.shape[2]) for f in pyramid]
    out = _sample_grouped(levels, points.reshape(b, 1, n * g * p, 3), tau)
    return out.reshape(b, n, g, p, -1)


def group_pyramid(pyramid: Sequence[Tensor], groups: int):
    """Each level ``[B, H, W, C]`` as ``(feat [B, G, H*W, C/G], H, W)``: the
    channel slice of each sampling group, laid out once a forward for all
    stages' gathers."""
    out = []
    for f in pyramid:
        b, h, w, c = f.shape
        out.append((f.reshape(b, h * w, groups, c // groups).transpose(1, 2).contiguous(), h, w))
    return out


def sample_groups(levels, points: Tensor, tau: float = 2.0) -> Tensor:
    """``points`` ``[B, N, G, P, 3]``, group ``g`` sampling its channel slice of
    :func:`group_pyramid`'s levels -> ``[B, N, G, P, C/G]`` (the JAX stage's
    loop of :func:`sample_3d` over groups)."""
    b, n, g, p, _ = points.shape
    pts = points.permute(0, 2, 1, 3, 4).reshape(b, g, n * p, 3)
    out = _sample_grouped(levels, pts, tau)  # [B, G, N*P, c]
    return out.reshape(b, g, n, p, -1).permute(0, 2, 1, 3, 4)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class AdaptiveMixing(nn.Module):
    """Query-generated channel + spatial mixing of sampled values.

    values ``[B, N, G, P_in, C/G]`` -> ``[B, N, C]`` (output projection
    included).  The generators start with zero weights and torch Linear's
    uniform +-1/sqrt(fan_in) biases (:meth:`reset_generators`): with both at
    zero the mixing matrices vanish and relu(LayerNorm(0)) passes no
    gradient."""

    def __init__(self, content_dim: int, groups: int = 4, in_points: int = 32,
                 out_points: int = 128):
        super().__init__()
        self.groups, self.in_points, self.out_points = groups, in_points, out_points
        cg = content_dim // groups
        self.channel_mixer = nn.Linear(content_dim, groups * cg * cg)
        self.spatial_mixer = nn.Linear(content_dim, groups * out_points * in_points)
        self.ln_c = nn.LayerNorm(cg, eps=LN_EPS)
        self.ln_s = nn.LayerNorm(cg, eps=LN_EPS)
        self.out_proj = nn.Linear(groups * out_points * cg, content_dim)

    @torch.no_grad()
    def reset_generators(self, generator: torch.Generator) -> None:
        for lin in (self.channel_mixer, self.spatial_mixer):
            bound = 1.0 / math.sqrt(lin.in_features)
            lin.weight.zero_()
            lin.bias.copy_(torch.rand(lin.bias.shape, generator=generator) * 2 * bound - bound)

    def forward(self, query: Tensor, values: Tensor) -> Tensor:
        with span("mixing"):
            b, n, g, p_in, cg = values.shape
            m_c = self.channel_mixer(query).reshape(b, n, g, cg, cg)
            m_s = self.spatial_mixer(query).reshape(b, n, g, self.out_points, p_in)
            out = F.relu(self.ln_c(torch.einsum("bngpc,bngcd->bngpd", values, m_c)))
            out = F.relu(self.ln_s(torch.einsum("bngop,bngpc->bngoc", m_s, out)))
            return self.out_proj(out.reshape(b, n, -1))


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` as explicit projections: the
    ``[D, H, D/H]`` kernels flattened into ``Linear(D, D)`` weights."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        b, n, d = q.shape
        h = self.num_heads
        hd = d // h
        qh = self.query(q).reshape(b, n, h, hd) / math.sqrt(hd)
        kh = self.key(k).reshape(b, k.shape[1], h, hd)
        vh = self.value(v).reshape(b, v.shape[1], h, hd)
        attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", attn, vh).reshape(b, n, d))


def _initial_offsets(groups: int, in_points: int) -> np.ndarray:
    """The offset generator's bias: points start as a small grid around the
    box centre, ``[G * P_in * 3]``."""
    side = int(np.ceil(np.sqrt(in_points)))
    xs, ys = np.meshgrid(np.linspace(-0.25, 0.25, side), np.linspace(-0.25, 0.25, side))
    pts = np.stack([xs.ravel(), ys.ravel()], -1)[:in_points]
    out = np.zeros((groups, in_points, 3), np.float32)
    out[:, :, :2] = pts
    return out.reshape(-1)


class AdaMixerStage(nn.Module):
    def __init__(self, num_classes: int, content_dim: int = 256, num_heads: int = 8,
                 groups: int = 4, in_points: int = 32, out_points: int = 128,
                 ffn_dim: int = 2048):
        super().__init__()
        d = content_dim
        self.content_dim, self.groups, self.in_points = d, groups, in_points
        self.pos_proj = nn.Linear(d, d)
        self.self_attn = SelfAttention(d, num_heads)
        self.ln_attn = nn.LayerNorm(d, eps=LN_EPS)
        self.offset_generator = nn.Linear(d, groups * in_points * 3)
        self.adaptive_mixing = AdaptiveMixing(d, groups, in_points, out_points)
        self.ln_mix = nn.LayerNorm(d, eps=LN_EPS)
        self.ffn1 = nn.Linear(d, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, d)
        self.ln_ffn = nn.LayerNorm(d, eps=LN_EPS)
        self.fc_cls = nn.Linear(d, num_classes)
        self.reg_fc0 = nn.Linear(d, d)
        self.reg_fc1 = nn.Linear(d, d)
        self.fc_reg = nn.Linear(d, 4)

    @torch.no_grad()
    def reset_special(self, generator: torch.Generator) -> None:
        """The JAX stage's non-default initialisers (after the LeCun-normal
        kernels and zero biases of ``weights.init_parameters``)."""
        self.offset_generator.weight.zero_()
        self.offset_generator.bias.copy_(torch.from_numpy(
            _initial_offsets(self.groups, self.in_points)))
        self.adaptive_mixing.reset_generators(generator)
        self.fc_cls.bias.fill_(CLS_PRIOR_BIAS)
        self.fc_reg.weight.zero_()

    def forward(self, levels, query: Tensor, xyzr: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """-> (new query, new xyzr, cls_logits ``[B, N, K]``)."""
        b, n, _ = query.shape
        qk = query + self.pos_proj(position_embedding(xyzr, self.content_dim))
        query = self.ln_attn(query + self.self_attn(qk, qk, query))

        off = self.offset_generator(query).reshape(b, n, self.groups, self.in_points, 3)
        x, y, z, r = xyzr.unbind(-1)
        w, h = _wh(z, r)
        base = torch.stack([x, y, z], dim=-1)[:, :, None, None, :]
        scale = torch.stack([w, h, torch.ones_like(z)], dim=-1)[:, :, None, None, :]
        with span("sample"):
            values = sample_groups(levels, base + off * scale)  # [B, N, G, P_in, C/G]

        query = self.ln_mix(query + self.adaptive_mixing(query, values))
        query = self.ln_ffn(query + self.ffn2(F.relu(self.ffn1(query))))

        cls_logits = self.fc_cls(query)
        reg = F.relu(self.reg_fc1(F.relu(self.reg_fc0(query))))
        return query, apply_deltas(xyzr, self.fc_reg(reg)), cls_logits


class AdaMixerOutputs(NamedTuple):
    cls_logits: Tensor  # [S, B, N, K] per stage
    boxes: Tensor  # [S, B, N, 4] per stage (x1y1x2y2, image pixels)


class AdaMixerDecoder(nn.Module):
    def __init__(self, num_classes: int = C.HICO_NUM_OBJECTS, num_queries: int = 100,
                 num_stages: int = 6, content_dim: int = 256, groups: int = 4,
                 in_points: int = 32, out_points: int = 128, ffn_dim: int = 2048):
        super().__init__()
        self.num_stages, self.groups = num_stages, groups
        self.init_content_features = nn.Parameter(torch.zeros(num_queries, content_dim))
        # The ChannelMapper role of the official neck: only when the widths differ.
        self.num_level_proj = 4 if C.FPN_CHANNELS != content_dim else 0
        for i in range(self.num_level_proj):
            setattr(self, f"level_proj{i}", nn.Linear(C.FPN_CHANNELS, content_dim))
        for s in range(num_stages):
            setattr(self, f"stage{s}", AdaMixerStage(num_classes, content_dim, groups=groups,
                                                     in_points=in_points, out_points=out_points,
                                                     ffn_dim=ffn_dim))

    def forward(self, pyramid: Sequence[Tensor], image_hw: Tuple[float, float]) -> AdaMixerOutputs:
        with span("decoder"):
            b = pyramid[0].shape[0]
            ih, iw = image_hw
            q, d = self.init_content_features.shape
            query = self.init_content_features[None].expand(b, q, d)
            init_box = torch.tensor([0.0, 0.0, float(iw), float(ih)], dtype=query.dtype,
                                    device=query.device)
            xyzr = box_to_xyzr(init_box).expand(b, q, 4)
            if self.num_level_proj:
                pyramid = [getattr(self, f"level_proj{i}")(f) for i, f in enumerate(pyramid)]
            levels = group_pyramid(pyramid, self.groups)
            all_logits, all_boxes = [], []
            for s in range(self.num_stages):
                query, xyzr, logits = getattr(self, f"stage{s}")(levels, query, xyzr)
                all_logits.append(logits)
                all_boxes.append(xyzr_to_box(xyzr))
            return AdaMixerOutputs(torch.stack(all_logits), torch.stack(all_boxes))


class AdaMixerDetector(nn.Module):
    """Backbone + FPN + AdaMixer decoder (the reference's stage-1 detector),
    on ``device`` (default ``cuda``; the CPU only when asked for), with
    weights from seed 0.  Images go in as ``[B, H, W, 3]`` in [0, 1]: the model
    normalises them itself.  ``frozen_stages`` passes to the ResNet-50 as
    mmdet's (the published recipe freezes the stem and ``layer1``: 1); the
    default -1 trains every stage, as the JAX package does."""

    def __init__(self, num_classes: int = C.HICO_NUM_OBJECTS, num_queries: int = 100,
                 num_stages: int = 6, content_dim: int = 256, groups: int = 4,
                 in_points: int = 32, out_points: int = 128, ffn_dim: int = 2048,
                 device: Optional[Union[str, torch.device]] = None, frozen_stages: int = -1):
        super().__init__()
        device = resolve_device(device)
        # seeded here, then moved
        self.backbone = DetectorBackbone(device="cpu", frozen_stages=frozen_stages)
        self.decoder = AdaMixerDecoder(num_classes, num_queries, num_stages, content_dim, groups,
                                       in_points, out_points, ffn_dim)
        g = torch.Generator().manual_seed(0)
        init_parameters(self, 0)
        with torch.no_grad():
            self.decoder.init_content_features.normal_(0.0, 0.02, generator=g)
        for s in range(num_stages):
            getattr(self.decoder, f"stage{s}").reset_special(g)
        self.register_buffer("mean", torch.tensor(C.IMAGE_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(C.IMAGE_STD), persistent=False)
        self.to(device=device)

    def forward(self, images: Tensor) -> AdaMixerOutputs:
        pyramid = self.backbone((images.float() - self.mean) / self.std)
        return self.decoder(pyramid, tuple(images.shape[1:3]))


# ---------------------------------------------------------------------------
# Set-prediction loss: Hungarian matching on the host, the loss on the device.
# ---------------------------------------------------------------------------

def _giou_terms(b1: Tensor, b2: Tensor) -> Tensor:
    """GIoU of broadcast box pairs ``[..., 4]`` -> ``[...]``."""
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    wh = (torch.minimum(b1[..., 2:], b2[..., 2:]) - torch.maximum(b1[..., :2], b2[..., :2])).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / union.clamp_min(1e-6)
    wh_h = (torch.maximum(b1[..., 2:], b2[..., 2:]) - torch.minimum(b1[..., :2], b2[..., :2])).clamp_min(0)
    hull = (wh_h[..., 0] * wh_h[..., 1]).clamp_min(1e-6)
    return iou - (hull - union) / hull


def _giou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise GIoU ``[..., N, 4] x [..., M, 4] -> [..., N, M]``."""
    return _giou_terms(boxes1[..., :, None, :], boxes2[..., None, :, :])


def match_cost(cls_logits: Tensor, boxes: Tensor, gt_boxes: Tensor, gt_labels: Tensor,
               image_hw: Tuple[float, float], cls_w: float = 2.0, l1_w: float = 5.0,
               giou_w: float = 2.0) -> Tensor:
    """``[..., N, G]`` DETR cost matrix (focal class cost + normalised L1 +
    GIoU), batched over any leading dims of ``cls_logits [..., N, K]``,
    ``boxes [..., N, 4]``, ``gt_boxes [..., G, 4]``, ``gt_labels [..., G]``."""
    ih, iw = image_hw
    scale = torch.tensor([iw, ih, iw, ih], dtype=torch.float32, device=boxes.device)
    p = torch.sigmoid(cls_logits)
    alpha, gamma = 0.25, 2.0
    pos_cost = alpha * ((1 - p) ** gamma) * (-torch.log(p + 1e-8))
    neg_cost = (1 - alpha) * (p**gamma) * (-torch.log(1 - p + 1e-8))
    cols = gt_labels.long().clamp(0, cls_logits.shape[-1] - 1)[..., None, :].expand(
        *cls_logits.shape[:-1], gt_labels.shape[-1])
    cls_cost = torch.gather(pos_cost, -1, cols) - torch.gather(neg_cost, -1, cols)
    l1 = (boxes[..., :, None, :] / scale - gt_boxes[..., None, :, :] / scale).abs().sum(-1)
    return cls_w * cls_cost + l1_w * l1 - giou_w * _giou(boxes, gt_boxes)


def hungarian_match(cost: np.ndarray, gt_valid: np.ndarray) -> np.ndarray:
    """Host-side matching.  Returns per-GT query index (-1 for invalid GTs)."""
    from scipy.optimize import linear_sum_assignment

    idx = np.flatnonzero(gt_valid)
    out = np.full(cost.shape[1], -1, np.int64)
    if idx.size:
        rows, cols = linear_sum_assignment(cost[:, idx])
        out[idx[cols]] = rows
    return out


@torch.no_grad()
def compute_assignments(outputs: AdaMixerOutputs, gt_boxes: Tensor, gt_labels: Tensor,
                        gt_valid: Tensor, image_hw) -> np.ndarray:
    """Hungarian per (stage, image) -> ``[S, B, G]`` int64 (-1 unmatched).
    The ``[S, B, N, G]`` costs are computed in one batch where the outputs
    lie and copied to the host once; scipy then matches each."""
    with span("match"):
        cost = match_cost(outputs.cls_logits.float(), outputs.boxes.float(),
                          gt_boxes[None].float(), gt_labels[None], image_hw).cpu().numpy()
        valid = gt_valid.cpu().numpy().astype(bool)
        s, b = cost.shape[:2]
        out = np.zeros((s, b, cost.shape[-1]), np.int64)
        for si in range(s):
            for bi in range(b):
                out[si, bi] = hungarian_match(cost[si, bi], valid[bi])
        return out


def set_loss(outputs: AdaMixerOutputs, assignments: Tensor, gt_boxes: Tensor, gt_labels: Tensor,
             gt_valid: Tensor, image_hw, cls_w: float = 2.0, l1_w: float = 5.0,
             giou_w: float = 2.0) -> dict:
    """Per-stage focal + L1 + GIoU, averaged over stages, / the GT count.

    A valid GT left unmatched (``assign == -1``: more valid GTs than
    queries) contributes nothing.  Under data parallelism the GT count is
    the sum over the ranks, and each rank's loss is its local sum x world
    size / that count."""
    s, b, n, k = outputs.cls_logits.shape
    ih, iw = image_hw
    dev = outputs.boxes.device
    scale = torch.tensor([iw, ih, iw, ih], dtype=torch.float32, device=dev)
    n_gt = all_reduce_sum(gt_valid.sum().float()).clamp_min(1.0) / world_size()
    assignments = torch.as_tensor(assignments, device=dev).long()
    rows = torch.arange(b, device=dev)[:, None]
    total = 0.0
    for si in range(s):
        logits, boxes, assign = outputs.cls_logits[si], outputs.boxes[si], assignments[si]
        matched = (gt_valid > 0) & (assign >= 0)
        q_idx = torch.where(matched, assign, n)  # unmatched -> the dropped row n
        label = torch.where(matched, gt_labels.long(), 0)
        flat = ((rows * (n + 1) + q_idx) * k + label).reshape(-1)
        cls_t = torch.zeros(b * (n + 1) * k, device=dev).scatter_reduce(
            0, flat, matched.float().reshape(-1), "amax")
        cls_t = cls_t.reshape(b, n + 1, k)[:, :n]
        cls_loss = binary_focal_loss_with_logits(logits, cls_t, alpha=0.25, gamma=2.0,
                                                 reduction="sum") / n_gt
        pb = torch.gather(boxes, 1, assign.clamp(0, n - 1)[..., None].expand(b, -1, 4))
        m = matched[..., None]
        l1 = ((pb / scale - gt_boxes / scale).abs() * m).sum() / n_gt
        giou_loss = ((1.0 - _giou_terms(pb, gt_boxes)) * matched).sum() / n_gt
        total = total + cls_w * cls_loss + l1_w * l1 + giou_w * giou_loss
    return dict(set_loss=total / s)

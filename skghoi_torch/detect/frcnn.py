"""torchvision-format Faster R-CNN (ResNet-50 + FPN) for stage-1 detection.

Mirrors ``skghoi_tpu.detect.frcnn``: the torchvision
``fasterrcnn_resnet50_fpn`` inference path with static shapes (top-k in
place of data-dependent filtering, mask-style NMS), and
:func:`load_torch_fasterrcnn`, which reads a torchvision ``state_dict`` (the
key layouts before and after torchvision 0.13) or the reference's fine-tuned
``model_state_dict``, without torchvision.

- backbone: :class:`~skghoi_torch.models.resnet.ResNet50` (frozen BN) and
  :class:`~skghoi_torch.models.fpn.FPN`, with P6 as a ``max_pool2d`` of
  kernel 1 and stride 2 over P5 (``LastLevelMaxPool``);
- RPN: a shared 3x3 conv head and three anchors a cell (sizes 32..512, one a
  level; ratios 0.5, 1, 2; base anchors rounded like
  ``AnchorGenerator.generate_anchors``); the top 1 000 a level before NMS,
  NMS at 0.7 with the levels as categories, the top 1 000 overall;
- RoI heads: multi-scale RoIAlign 7x7 on P2..P5 through
  :func:`~skghoi_torch.ops.roi_align_cuda.roi_align_auto` (the CUDA kernel
  on the card, the plain version on the CPU), then :class:`TwoMLPHead`
  (fc6/fc7, 1024) and :class:`FastRCNNPredictor` (91 classes); a per-class
  decode with weights (10, 10, 5, 5), the score threshold, a fixed pool of
  the best 2 000 candidates, class-wise NMS at 0.5 and the top 100.

Every top-k is a stable descending sort, as ``jax.lax.top_k`` breaks ties
by index; the ``-inf`` scores of invalid entries sort last and mark them
invalid after the selection.  NMS is :func:`~skghoi_torch.ops.boxes.nms_keep`,
one vectorised step a box (no hand kernel: the JAX package's NMS is XLA).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skghoi_torch.device import resolve_device
from skghoi_torch.models.fpn import FPN
from skghoi_torch.models.layers import Conv2d, Linear
from skghoi_torch.models.resnet import ResNet50
from skghoi_torch.ops.boxes import batched_nms_keep
from skghoi_torch.ops.roi_align_cuda import roi_align_auto
from skghoi_torch.weights import cpu_float32, load_torch_resnet50

Tensor = torch.Tensor

ANCHOR_SIZES = (32, 64, 128, 256, 512)  # one a level, P2..P6
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
RPN_STRIDES = (4, 8, 16, 32, 64)
BBOX_XFORM_CLIP = math.log(1000.0 / 16)
BOX_CODER_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def anchors_for_level(canvas: Tuple[int, int], stride: int, size: int) -> np.ndarray:
    """torchvision ``AnchorGenerator`` anchors of one level, ``[H*W*3, 4]``:
    base anchors centred at 0 and rounded, shifted by ``stride * (x, y)``
    with no half-cell offset; cells in row-major order, three anchors each."""
    h_r = np.sqrt(np.asarray(ANCHOR_RATIOS))
    w_r = 1.0 / h_r
    ws = np.round(w_r * size / 2)
    hs = np.round(h_r * size / 2)
    base = np.stack([-ws, -hs, ws, hs], axis=1)  # [3, 4]
    gh, gw = canvas[0] // stride, canvas[1] // stride
    sy, sx = np.meshgrid(np.arange(gh) * stride, np.arange(gw) * stride, indexing="ij")
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4).astype(np.float32)


def decode_boxes(anchors: Tensor, deltas: Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> Tensor:
    """torchvision ``BoxCoder.decode_single``: the width and height deltas are
    clipped at ``log(1000/16)`` before ``exp``."""
    wx, wy, ww, wh = weights
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw * 0.5
    ay = anchors[..., 1] + ah * 0.5
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)
    cx = dx * aw + ax
    cy = dy * ah + ay
    bw = torch.exp(dw) * aw
    bh = torch.exp(dh) * ah
    return torch.stack([cx - bw * 0.5, cy - bh * 0.5, cx + bw * 0.5, cy + bh * 0.5], dim=-1)


def clip_boxes(boxes: Tensor, hw: Tensor) -> Tensor:
    """Clip xyxy boxes to ``[0, w] x [0, h]``; ``hw`` broadcasts as (h, w)."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), hw[..., 1])
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), hw[..., 0])
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), hw[..., 1])
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), hw[..., 0])
    return torch.stack([x1, y1, x2, y2], dim=-1)


def top_k(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest, ties in index
    order (a stable descending sort)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _take_rows(x: Tensor, idx: Tensor) -> Tensor:
    """``x[b, idx[b, i]]`` for ``x`` of shape ``[B, N, ...]``."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(
        *idx.shape, *x.shape[2:]))


class RPNHead(nn.Module):
    """Shared 3x3 conv, then 1x1 objectness and box-delta predictions.

    ``[B, H, W, C]`` (NHWC) in; logits ``[B, H*W*A]`` and deltas
    ``[B, H*W*A, 4]`` out, flattened ``(H, W, A)`` as torchvision's
    ``concat_box_prediction_layers`` orders them."""

    def __init__(self, channels: int = 256, num_anchors: int = len(ANCHOR_RATIOS),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)
        self.cls_logits = Conv2d(channels, num_anchors, 1, dtype=dtype)
        self.bbox_pred = Conv2d(channels, num_anchors * 4, 1, dtype=dtype)

    def forward(self, feat: Tensor) -> Tuple[Tensor, Tensor]:
        x = F.relu(self.conv(feat.permute(0, 3, 1, 2)))
        b = feat.shape[0]
        logits = self.cls_logits(x).permute(0, 2, 3, 1).reshape(b, -1)
        deltas = self.bbox_pred(x).permute(0, 2, 3, 1).reshape(b, -1, 4)
        return logits.float(), deltas.float()


class TwoMLPHead(nn.Module):
    """fc6/fc7 over the pooled features.  ``[N, 7, 7, C]`` (NHWC) in; the
    flatten is torchvision's channel-major ``[N, C, 7, 7]`` order, so fc6
    takes torchvision's weight as it is."""

    def __init__(self, in_features: int = 256 * 7 * 7, representation: int = 1024,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc6 = Linear(in_features, representation, dtype=dtype)
        self.fc7 = Linear(representation, representation, dtype=dtype)

    def forward(self, pooled: Tensor) -> Tensor:
        x = pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1)
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_features: int = 1024, num_classes: int = 91,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.cls_score = Linear(in_features, num_classes, dtype=dtype)
        self.bbox_pred = Linear(in_features, num_classes * 4, dtype=dtype)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        return self.cls_score(x), self.bbox_pred(x).reshape(-1, self.num_classes, 4)


class FRCNNDetections(NamedTuple):
    boxes: Tensor  # [B, D, 4]
    labels: Tensor  # [B, D] COCO ids (slots past the detections hold a real label, masked)
    scores: Tensor  # [B, D]
    valid: Tensor  # [B, D] bool


class Candidates(NamedTuple):
    """A pool that NMS selects from: the best M per-class boxes by score
    (:meth:`FasterRCNN.classify`), or the RPN's per-level top-k with their
    levels as labels (:meth:`FasterRCNN.rpn_candidates`)."""
    boxes: Tensor  # [B, M, 4]
    scores: Tensor  # [B, M] (-inf where invalid after classify)
    labels: Tensor  # [B, M]
    valid: Tensor  # [B, M] bool


class Proposals(NamedTuple):
    boxes: Tensor  # [B, K, 4]
    scores: Tensor  # [B, K] objectness probability (-inf where invalid)
    valid: Tensor  # [B, K] bool
    candidates: int  # RPN boxes entering its NMS, an image (one NMS step each)
    levels: Tensor  # [B, K] the RPN level (P2..P6 as 0..4) each proposal came from


class FasterRCNN(nn.Module):
    """Inference-only torchvision Faster R-CNN with static shapes, on
    ``device`` (default ``cuda``; the CPU only when asked for)."""

    def __init__(self, num_classes: int = 91, pre_nms_top_n: int = 1000,
                 post_nms_top_n: int = 1000, rpn_nms_thresh: float = 0.7,
                 box_score_thresh: float = 0.05, box_nms_thresh: float = 0.5,
                 detections_per_img: int = 100, score_topk: int = 2000,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.num_classes = num_classes
        self.pre_nms_top_n = pre_nms_top_n
        self.post_nms_top_n = post_nms_top_n
        self.rpn_nms_thresh = rpn_nms_thresh
        self.box_score_thresh = box_score_thresh
        self.box_nms_thresh = box_nms_thresh
        self.detections_per_img = detections_per_img
        self.score_topk = score_topk  # fixed-shape stand-in for score-threshold filtering
        self.body = ResNet50(dtype=dtype)
        self.fpn = FPN(dtype=dtype)
        self.rpn_head = RPNHead(dtype=dtype)
        self.box_head = TwoMLPHead(dtype=dtype)
        self.box_predictor = FastRCNNPredictor(num_classes=num_classes, dtype=dtype)
        self.to(device=resolve_device(device), memory_format=torch.channels_last)
        self._anchors: Dict[Tuple, Tensor] = {}

    def features(self, images: Tensor) -> Tuple[Tensor, ...]:
        """``[B, H, W, 3]`` normalised images -> P2..P5 as contiguous
        ``[B, H_l, W_l, 256]`` float32 maps (NHWC views of the convs'
        channels_last outputs)."""
        pyramid = self.fpn(self.body(images.permute(0, 3, 1, 2)))
        return tuple(p.permute(0, 2, 3, 1).float() for p in pyramid)

    def anchors(self, canvas: Tuple[int, int], level: int, device) -> Tensor:
        key = (canvas, level, str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(anchors_for_level(
                canvas, RPN_STRIDES[level], ANCHOR_SIZES[level])).to(device)
        return self._anchors[key]

    def rpn_candidates(self, feats: Tuple[Tensor, ...], canvas: Tuple[int, int],
                       image_sizes: Tensor) -> Candidates:
        """The RPN's candidate pool over P2..P6: per-level top-k, decoded and
        clipped, labelled with their level; ``valid`` drops boxes under
        1e-3 on a side."""
        p6 = F.max_pool2d(feats[-1].permute(0, 3, 1, 2), 1, stride=2).permute(0, 2, 3, 1)
        b = feats[0].shape[0]
        all_boxes, all_scores, all_lvl = [], [], []
        for lvl, f in enumerate((*feats, p6)):
            logits, deltas = self.rpn_head(f)
            k = min(self.pre_nms_top_n, logits.shape[1])
            top, idx = top_k(logits, k)
            anchors = self.anchors(canvas, lvl, f.device)
            all_boxes.append(decode_boxes(anchors[idx], _take_rows(deltas, idx)))
            all_scores.append(top)
            all_lvl.append(torch.full((b, k), lvl, dtype=torch.int64, device=f.device))
        boxes = torch.cat(all_boxes, 1)
        scores = torch.sigmoid(torch.cat(all_scores, 1))
        lvls = torch.cat(all_lvl, 1)

        hw = image_sizes[:, None, :].float()
        boxes = clip_boxes(boxes, hw)
        ok = ((boxes[..., 2] - boxes[..., 0]) >= 1e-3) & ((boxes[..., 3] - boxes[..., 1]) >= 1e-3)
        return Candidates(boxes, scores, lvls, ok)

    def propose(self, feats: Tuple[Tensor, ...], canvas: Tuple[int, int],
                image_sizes: Tensor) -> Proposals:
        """The RPN: :meth:`rpn_candidates`, NMS across levels with the levels
        as categories, then the overall top-k."""
        boxes, scores, lvls, ok = self.rpn_candidates(feats, canvas, image_sizes)
        keep = batched_nms_keep(boxes, scores, lvls, ok, self.rpn_nms_thresh)
        prop_scores = torch.where(keep, scores, torch.full_like(scores, -math.inf))
        top, idx = top_k(prop_scores, min(self.post_nms_top_n, prop_scores.shape[1]))
        return Proposals(_take_rows(boxes, idx).contiguous(), top, torch.isfinite(top),
                         boxes.shape[1], torch.gather(lvls, 1, idx))

    def classify(self, feats: Tuple[Tensor, ...], proposals: Proposals,
                 image_sizes: Tensor) -> Candidates:
        """The RoI heads up to the candidate pool: pooling, fc6/fc7, the
        predictor, the per-class decode, the score threshold and the best
        ``score_topk`` boxes."""
        boxes, prop_valid = proposals.boxes, proposals.valid
        b, k = boxes.shape[:2]
        pooled = roi_align_auto(feats, boxes)  # [B, K, 7, 7, 256]
        x = self.box_head(pooled.reshape(b * k, *pooled.shape[2:]))
        cls_scores, box_deltas = self.box_predictor(x)
        c = self.num_classes
        probs = torch.softmax(cls_scores.float(), dim=-1).reshape(b, k, c)
        box_deltas = box_deltas.float().reshape(b, k, c, 4)

        hw = image_sizes[:, None, :].float()
        dec = decode_boxes(boxes[:, :, None, :], box_deltas[:, :, 1:, :], BOX_CODER_WEIGHTS)
        dec = clip_boxes(dec, hw[:, :, None, :])  # [B, K, C-1, 4]
        flat_boxes = dec.reshape(b, -1, 4)
        flat_scores = probs[:, :, 1:].reshape(b, -1)
        flat_labels = torch.arange(1, c, device=boxes.device).repeat(k)[None].expand(b, -1)
        flat_valid = prop_valid[:, :, None].expand(b, k, c - 1).reshape(b, -1)
        flat_valid = (flat_valid & (flat_scores > self.box_score_thresh)
                      & ((flat_boxes[..., 2] - flat_boxes[..., 0]) >= 1e-2)
                      & ((flat_boxes[..., 3] - flat_boxes[..., 1]) >= 1e-2))

        neg_inf = torch.full_like(flat_scores, -math.inf)
        cand_scores, idx = top_k(torch.where(flat_valid, flat_scores, neg_inf),
                                 min(self.score_topk, flat_scores.shape[1]))
        cand_boxes = _take_rows(flat_boxes, idx)
        cand_labels = torch.gather(flat_labels, 1, idx)
        return Candidates(cand_boxes, cand_scores, cand_labels, torch.isfinite(cand_scores))

    def select(self, cand: Candidates) -> FRCNNDetections:
        """Class-wise NMS over the candidate pool, then the final top-k."""
        cand_boxes, cand_scores, cand_labels, cand_valid = cand
        keep = batched_nms_keep(cand_boxes, torch.where(cand_valid, cand_scores, 0.0),
                                cand_labels, cand_valid, self.box_nms_thresh)
        final = torch.where(keep & cand_valid, cand_scores, torch.full_like(cand_scores, -math.inf))
        top, idx = top_k(final, min(self.detections_per_img, final.shape[1]))
        valid = torch.isfinite(top)
        return FRCNNDetections(boxes=_take_rows(cand_boxes, idx),
                               labels=torch.gather(cand_labels, 1, idx),
                               scores=torch.where(valid, top, torch.zeros_like(top)),
                               valid=valid)

    @torch.no_grad()
    def forward(self, images: Tensor, image_sizes: Tensor) -> FRCNNDetections:
        """``images``: ``[B, H, W, 3]``, normalised and resized into the
        canvas; ``image_sizes``: ``[B, 2]`` (h, w) valid extents."""
        feats = self.features(images)
        proposals = self.propose(feats, tuple(images.shape[1:3]), image_sizes)
        return self.select(self.classify(feats, proposals, image_sizes))


# --------------------------------------------------------------------------
# torchvision state_dict -> the port's state_dict
# --------------------------------------------------------------------------

def _first(sd: Mapping[str, Any], *names: str) -> str:
    for n in names:
        if n + ".weight" in sd:
            return n
    raise KeyError(f"none of {names} in the state dict")


def load_torch_fasterrcnn(state_dict: Mapping[str, Any]) -> Dict[str, Tensor]:
    """A torchvision ``fasterrcnn_resnet50_fpn`` ``state_dict`` -> the
    ``state_dict`` of :class:`FasterRCNN` (float32 CPU tensors).

    Both key layouts: before torchvision 0.13 (``rpn.head.conv.weight``,
    ``backbone.fpn.inner_blocks.0.weight``) and after
    (``rpn.head.conv.0.0.weight``, ``backbone.fpn.inner_blocks.0.0.weight``)."""
    sd = state_dict
    out = {f"body.{k}": v for k, v in load_torch_resnet50(sd, prefix="backbone.body.").items()}

    def put(dst: str, src: str):
        for t in ("weight", "bias"):
            if f"{src}.{t}" in sd:
                out[f"{dst}.{t}"] = cpu_float32(sd[f"{src}.{t}"])

    for i in range(4):
        put(f"fpn.lateral.{i}", _first(sd, f"backbone.fpn.inner_blocks.{i}.0",
                                       f"backbone.fpn.inner_blocks.{i}"))
        put(f"fpn.output.{i}", _first(sd, f"backbone.fpn.layer_blocks.{i}.0",
                                      f"backbone.fpn.layer_blocks.{i}"))
    put("rpn_head.conv", _first(sd, "rpn.head.conv.0.0", "rpn.head.conv"))
    put("rpn_head.cls_logits", "rpn.head.cls_logits")
    put("rpn_head.bbox_pred", "rpn.head.bbox_pred")
    for name in ("fc6", "fc7"):
        put(f"box_head.{name}", f"roi_heads.box_head.{name}")
    for name in ("cls_score", "bbox_pred"):
        put(f"box_predictor.{name}", f"roi_heads.box_predictor.{name}")
    return out


def random_state_dict(seed: int = 0, num_classes: int = 91,
                      new_style: bool = True) -> Dict[str, Tensor]:
    """Seeded random weights in torchvision's ``fasterrcnn_resnet50_fpn`` key
    layout (after 0.13, or before with ``new_style=False``), at full widths.

    No detector checkpoint is in the repository, so the tests and the smoke
    run drive the detector with these.  Convolutions and linear layers are
    LeCun-normal (``1/sqrt(fan_in)``) with small biases, and the frozen BN
    statistics are near identity, so activations stay of order 1 through the
    backbone; class probabilities then sit near ``1/num_classes``."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, Tensor] = {}

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    def conv(name, o, i, k, bias=True):
        sd[name + ".weight"] = t(rng.standard_normal((o, i, k, k)) / math.sqrt(i * k * k))
        if bias:
            sd[name + ".bias"] = t(rng.standard_normal(o) * 0.01)

    def bn(name, c):
        sd[name + ".weight"] = t(rng.uniform(0.5, 1.0, c))
        sd[name + ".bias"] = t(rng.standard_normal(c) * 0.05)
        sd[name + ".running_mean"] = t(rng.standard_normal(c) * 0.05)
        sd[name + ".running_var"] = t(rng.uniform(0.5, 1.5, c))
        sd[name + ".num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    def linear(name, o, i):
        sd[name + ".weight"] = t(rng.standard_normal((o, i)) / math.sqrt(i))
        sd[name + ".bias"] = t(rng.standard_normal(o) * 0.01)

    p = "backbone.body."
    conv(p + "conv1", 64, 3, 7, bias=False)
    bn(p + "bn1", 64)
    in_ch = 64
    for li, (blocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        out = width * 4
        for b in range(blocks):
            tb = f"{p}layer{li + 1}.{b}"
            conv(f"{tb}.conv1", width, in_ch if b == 0 else out, 1, bias=False)
            bn(f"{tb}.bn1", width)
            conv(f"{tb}.conv2", width, width, 3, bias=False)
            bn(f"{tb}.bn2", width)
            conv(f"{tb}.conv3", out, width, 1, bias=False)
            bn(f"{tb}.bn3", out)
            if b == 0:
                conv(f"{tb}.downsample.0", out, in_ch, 1, bias=False)
                bn(f"{tb}.downsample.1", out)
        in_ch = out
    suffix = ".0" if new_style else ""
    for i, c in enumerate((256, 512, 1024, 2048)):
        conv(f"backbone.fpn.inner_blocks.{i}{suffix}", 256, c, 1)
        conv(f"backbone.fpn.layer_blocks.{i}{suffix}", 256, 256, 3)
    conv("rpn.head.conv.0.0" if new_style else "rpn.head.conv", 256, 256, 3)
    conv("rpn.head.cls_logits", 3, 256, 1)
    conv("rpn.head.bbox_pred", 12, 256, 1)
    linear("roi_heads.box_head.fc6", 1024, 256 * 7 * 7)
    linear("roi_heads.box_head.fc7", 1024, 1024)
    linear("roi_heads.box_predictor.cls_score", num_classes, 1024)
    linear("roi_heads.box_predictor.bbox_pred", num_classes * 4, 1024)
    return sd


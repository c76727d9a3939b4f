"""AdaMixer-R50 (Gao et al., "AdaMixer: A Fast-Converging Query-Based Object
Detector", 2022, arXiv:2203.16507) in plain float32 PyTorch: the
ResNet-50 + FPN body of :mod:`hoibench.reference.layers`, then 6 decoder
stages over 100 queries, each a content vector and an ``(x, y, z, r)`` box
(``z = log2 sqrt(wh)``, ``r = log2 h/w``), and the set loss with its own
Hungarian matching.  A stage:

1. self-attention across queries, keys and queries offset by a projected
   sinusoidal embedding of the box, then a residual LayerNorm;
2. adaptive 3D sampling: a linear map of the query gives ``G x P_in``
   offsets ``(dx, dy, dz)``; point ``(x + dx w, y + dy h, z + dz)`` of group
   ``g`` reads channels ``g C/G .. (g+1) C/G`` of every level bilinearly
   (``F.grid_sample``, border padding, ``align_corners=False``) and weighs
   the levels by ``softmax_l(-(z_p - log2 stride_l)^2 / tau)``;
3. adaptive mixing: per query and group a ``C/G x C/G`` channel matrix and a
   ``P_out x P_in`` spatial matrix, both linear maps of the query, each
   product followed by LayerNorm and ReLU, then a linear map of the flattened
   ``P_out x C/G x G`` values to the content width and a residual LayerNorm;
4. an FFN with a residual LayerNorm, a class head, and a box head whose
   ``(dx, dy, dz, dr)`` moves x and y in units of the box's w and h and adds
   to z and r.

The loss of each stage (averaged over the stages) is focal (alpha 0.25,
gamma 2) x 2 + L1 on canvas-normalised corners x 5 + (1 - GIoU) x 2, each
summed over the matched pairs (the focal term over every query and class)
and divided by the image batch's ground-truth count; the matching minimises
the same three costs (the focal one as positive minus negative cost).

Departures from the paper, each the JAX package's and so the program's:

- the neck is the FPN (lateral 1x1 and output 3x3 convolutions, nearest
  top-down), not the paper's ChannelMapper; a per-level linear map to the
  content width only where that differs from 256;
- every LayerNorm takes eps 1e-6 (flax's default), and the mixing's two
  LayerNorms normalise each point's ``C/G`` channels with a learned scale and
  shift, where the official code normalises points and channels together
  without one;
- no IoF bias in the self-attention, one linear class head and a
  ReLU-linear-ReLU-linear box head without LayerNorms;
- the initial box is the whole canvas for every image, and L1 and the
  match normalise by the canvas (mmdet: by each image's own size);
- the focal term is ``(|t - p| + 1e-6)^gamma`` (the program's focal loss);
- no gradient clipping and a constant learning rate: the published
  schedule's warm-up and its steps are not run;
- the matching is a plain Hungarian (shortest augmenting paths) on the host.

Every product's operands go through ``quant``: the identity for the
reference, and for the control a rounding to TF32 (10 mantissa bits, to
nearest even), what the tensor cores do to float32 operands with TF32 on,
straight through for the backward.  Images are ``[B, H, W, 3]`` in [0, 1].
Names follow the program's modules, so one state dict loads into both.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hoibench.reference.layers import DetectorBackbone, Lin, Norm, Quant, identity, init_kinds

Tensor = torch.Tensor

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
HUMAN = 49
FPN = 256
LEVEL_LOGS = (2.0, 3.0, 4.0, 5.0)  # log2 of the strides 4, 8, 16, 32
LN_EPS = 1e-6
ALPHA, GAMMA, FOCAL_EPS = 0.25, 2.0, 1e-6
CLS_W, L1_W, GIOU_W = 2.0, 5.0, 2.0


def tf32(t: Tensor) -> Tensor:
    """``t`` rounded to TF32's 10 mantissa bits (to nearest even), straight through."""
    bits = t.detach().contiguous().view(torch.int32)
    odd = (bits >> 13) & 1
    q = ((bits + 0xFFF + odd) & ~0x1FFF).view(torch.float32)
    return t + (q - t.detach())


PRECISIONS = {"float32": identity, "tf32": tf32}


def quantizer(precision: str) -> Quant:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; known: {sorted(PRECISIONS)}")
    return PRECISIONS[precision]


# --- boxes -------------------------------------------------------------------------

def box_to_xyzr(boxes: Tensor) -> Tensor:
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-4)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-4)
    cx, cy = (boxes[..., 0] + boxes[..., 2]) / 2, (boxes[..., 1] + boxes[..., 3]) / 2
    return torch.stack([cx, cy, 0.5 * torch.log2(w * h), torch.log2(h / w)], -1)


def box_wh(xyzr: Tensor) -> Tuple[Tensor, Tensor]:
    z, r = xyzr[..., 2], xyzr[..., 3]
    return torch.exp2(z - r / 2), torch.exp2(z + r / 2)


def xyzr_to_box(xyzr: Tensor) -> Tensor:
    w, h = box_wh(xyzr)
    cx, cy = xyzr[..., 0], xyzr[..., 1]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def position_embedding(xyzr: Tensor, dim: int) -> Tensor:
    """Each coordinate over ``dim / 8`` frequencies ``10000^(-k / (dim / 8))``:
    its sines then its cosines, the four coordinates one after another."""
    half = dim // 8
    freq = 10000.0 ** (-torch.arange(half, dtype=xyzr.dtype, device=xyzr.device) / half)
    ang = xyzr[..., None] * freq
    return torch.cat([ang.sin(), ang.cos()], -1).flatten(-2)


def giou(a: Tensor, b: Tensor) -> Tensor:
    """GIoU of broadcast corner boxes."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lo, hi = torch.maximum(a[..., :2], b[..., :2]), torch.minimum(a[..., 2:], b[..., 2:])
    inter = (hi - lo).clamp_min(0).prod(-1)
    union = area_a + area_b - inter
    outer = (torch.maximum(a[..., 2:], b[..., 2:]) - torch.minimum(a[..., :2], b[..., :2]))
    hull = outer.clamp_min(0).prod(-1).clamp_min(1e-6)
    return inter / union.clamp_min(1e-6) - (hull - union) / hull


# --- the decoder ---------------------------------------------------------------------

def sample_points(maps: Sequence[Tensor], points: Tensor, groups: int, tau: float) -> Tensor:
    """``maps``: four ``[B, C, H_l, W_l]`` levels; ``points`` ``[B, N, G, P, 3]``
    (x, y in canvas pixels, z in log2 pixels) -> ``[B, N, G, P, C/G]``."""
    b, n, g, p, _ = points.shape
    x, y, z = points.unbind(-1)
    logs = torch.tensor(LEVEL_LOGS, dtype=points.dtype, device=points.device)
    level_w = torch.softmax(-((z[..., None] - logs) ** 2) / tau, -1)
    out = 0.0
    for level, feat in enumerate(maps):
        c, h, w = feat.shape[1] // groups, feat.shape[2], feat.shape[3]
        stride = 2.0 ** LEVEL_LOGS[level]
        grid = torch.stack([2 * x / (stride * w) - 1, 2 * y / (stride * h) - 1], -1)
        grid = grid.permute(0, 2, 1, 3, 4).reshape(b * g, n, p, 2)
        got = F.grid_sample(feat.reshape(b * g, c, h, w), grid, mode="bilinear",
                            padding_mode="border", align_corners=False)  # [B*G, c, N, P]
        got = got.reshape(b, g, c, n, p).permute(0, 3, 1, 4, 2)
        out = out + got * level_w[..., level:level + 1]
    return out


class SelfAttention(nn.Module):
    def __init__(self, d: int, heads: int, quant: Quant):
        super().__init__()
        self.query, self.key = Lin(d, d, quant=quant), Lin(d, d, quant=quant)
        self.value, self.out = Lin(d, d, quant=quant), Lin(d, d, quant=quant)
        self.heads, self.quant = heads, quant

    def forward(self, qk: Tensor, v: Tensor) -> Tensor:
        b, n, d = qk.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, n, self.heads, hd).transpose(1, 2)

        q = split(self.query(qk)) / math.sqrt(hd)
        k, val = split(self.key(qk)), split(self.value(v))
        attn = torch.softmax(self.quant(q) @ self.quant(k).transpose(-1, -2), -1)
        return self.out((self.quant(attn) @ self.quant(val)).transpose(1, 2).reshape(b, n, d))


class Mixing(nn.Module):
    def __init__(self, d: int, groups: int, p_in: int, p_out: int, quant: Quant):
        super().__init__()
        c = d // groups
        self.channel_mixer = Lin(d, groups * c * c, quant=quant)
        self.spatial_mixer = Lin(d, groups * p_out * p_in, quant=quant)
        self.ln_c, self.ln_s = Norm(c, LN_EPS), Norm(c, LN_EPS)
        self.out_proj = Lin(groups * p_out * c, d, quant=quant)
        self.p_out, self.quant = p_out, quant

    def forward(self, query: Tensor, values: Tensor) -> Tensor:
        b, n, g, p_in, c = values.shape
        q = self.quant
        m_c = self.channel_mixer(query).reshape(b, n, g, c, c)
        m_s = self.spatial_mixer(query).reshape(b, n, g, self.p_out, p_in)
        x = F.relu(self.ln_c(torch.einsum("bngpc,bngcd->bngpd", q(values), q(m_c))))
        x = F.relu(self.ln_s(torch.einsum("bngop,bngpc->bngoc", q(m_s), q(x))))
        return self.out_proj(x.reshape(b, n, -1))


class Stage(nn.Module):
    def __init__(self, classes: int, d: int, heads: int, groups: int, p_in: int, p_out: int,
                 ffn: int, tau: float, quant: Quant):
        super().__init__()
        lin = lambda i, o: Lin(i, o, quant=quant)  # noqa: E731
        self.pos_proj = lin(d, d)
        self.self_attn = SelfAttention(d, heads, quant)
        self.ln_attn = Norm(d, LN_EPS)
        self.offset_generator = lin(d, groups * p_in * 3)
        self.adaptive_mixing = Mixing(d, groups, p_in, p_out, quant)
        self.ln_mix = Norm(d, LN_EPS)
        self.ffn1, self.ffn2 = lin(d, ffn), lin(ffn, d)
        self.ln_ffn = Norm(d, LN_EPS)
        self.fc_cls = lin(d, classes)
        self.reg_fc0, self.reg_fc1, self.fc_reg = lin(d, d), lin(d, d), lin(d, 4)
        self.groups, self.p_in, self.tau = groups, p_in, tau

    def forward(self, maps, query: Tensor, xyzr: Tensor):
        b, n, d = query.shape
        qk = query + self.pos_proj(position_embedding(xyzr, d))
        query = self.ln_attn(query + self.self_attn(qk, query))
        off = self.offset_generator(query).reshape(b, n, self.groups, self.p_in, 3)
        w, h = box_wh(xyzr)
        centre = torch.stack([xyzr[..., 0], xyzr[..., 1], xyzr[..., 2]], -1)[:, :, None, None]
        scale = torch.stack([w, h, torch.ones_like(w)], -1)[:, :, None, None]
        values = sample_points(maps, centre + off * scale, self.groups, self.tau)
        query = self.ln_mix(query + self.adaptive_mixing(query, values))
        query = self.ln_ffn(query + self.ffn2(F.relu(self.ffn1(query))))
        delta = self.fc_reg(F.relu(self.reg_fc1(F.relu(self.reg_fc0(query)))))
        moved = torch.stack([xyzr[..., 0] + delta[..., 0] * w, xyzr[..., 1] + delta[..., 1] * h,
                             xyzr[..., 2] + delta[..., 2], xyzr[..., 3] + delta[..., 3]], -1)
        return query, moved, self.fc_cls(query)


class Decoder(nn.Module):
    def __init__(self, classes: int, queries: int, stages: int, d: int, heads: int, groups: int,
                 p_in: int, p_out: int, ffn: int, tau: float, quant: Quant):
        super().__init__()
        self.init_content_features = nn.Parameter(torch.empty(queries, d))
        self.level_proj = d != FPN
        for i in range(4 if self.level_proj else 0):
            setattr(self, f"level_proj{i}", Lin(FPN, d, quant=quant))
        for s in range(stages):
            setattr(self, f"stage{s}", Stage(classes, d, heads, groups, p_in, p_out, ffn, tau,
                                             quant))
        self.stages = stages

    def forward(self, pyramid: Sequence[Tensor], canvas: Tuple[int, int]):
        if self.level_proj:
            pyramid = [getattr(self, f"level_proj{i}")(f) for i, f in enumerate(pyramid)]
        maps = [f.permute(0, 3, 1, 2) for f in pyramid]
        b = maps[0].shape[0]
        query = self.init_content_features[None].expand(b, -1, -1)
        whole = torch.tensor([0.0, 0.0, float(canvas[1]), float(canvas[0])], dtype=query.dtype,
                             device=query.device)
        xyzr = box_to_xyzr(whole).expand(b, query.shape[1], 4)
        logits, boxes = [], []
        for s in range(self.stages):
            query, xyzr, cls = getattr(self, f"stage{s}")(maps, query, xyzr)
            logits.append(cls)
            boxes.append(xyzr_to_box(xyzr))
        return torch.stack(logits), torch.stack(boxes)


class AdaMixer(nn.Module):
    """``forward(images) -> (logits [S, B, N, K], boxes [S, B, N, 4])``."""

    def __init__(self, cfg: dict, quant: Quant = identity):
        super().__init__()
        self.backbone = DetectorBackbone(cfg["frozen_stages"], quant)
        self.decoder = Decoder(cfg["num_classes"], cfg["num_queries"], cfg["num_stages"],
                               cfg["content_dim"], cfg["num_heads"], cfg["groups"],
                               cfg["in_points"], cfg["out_points"], cfg["ffn_dim"], cfg["tau"],
                               quant)

    def init_kinds(self) -> dict:
        """The layers' kinds, and: distinct queries (standard normal); the
        sampling offsets' bias U(-0.5, 0.5) box sizes, their weight and the box
        head's at a tenth of LeCun's scale (points and boxes move by a fraction
        of the box a stage); the class bias at the focal prior -4.595 +- 0.5."""
        over = {"decoder.init_content_features": ("normal", 1.0)}
        for name, m in self.named_modules():
            if isinstance(m, Stage):
                for lin in ("offset_generator", "fc_reg"):
                    fan_in = getattr(m, lin).weight.shape[1]
                    over[f"{name}.{lin}.weight"] = ("normal", 0.1 * fan_in ** -0.5)
                over[f"{name}.offset_generator.bias"] = ("uniform", 0.5)
                over[f"{name}.fc_cls.bias"] = ("uniform", 0.5, -4.595)
        return init_kinds(self, over)

    def forward(self, images: Tensor):
        dev = images.device
        x = (images - torch.tensor(MEAN, device=dev)) / torch.tensor(STD, device=dev)
        return self.decoder(self.backbone(x), tuple(images.shape[1:3]))


# --- the set loss ------------------------------------------------------------------

def ground_truth(batch: Dict[str, Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    """The detector's ground truth from the HOI pairs: human boxes (class 49)
    then object boxes, each (class, box to 0.1 px) of an image once."""
    boxes = torch.cat([batch["gt_boxes_h"], batch["gt_boxes_o"]], 1)
    labels = torch.cat([torch.full_like(batch["gt_object"], HUMAN), batch["gt_object"]], 1)
    valid = torch.cat([batch["gt_valid"], batch["gt_valid"]], 1).cpu().numpy()
    keys = np.round(boxes.detach().cpu().double().numpy(), 1)
    lab = labels.cpu().numpy()
    first = np.zeros_like(valid)
    for i in range(valid.shape[0]):
        seen = set()
        for j in np.flatnonzero(valid[i]):
            key = (int(lab[i, j]), *keys[i, j].tolist())
            first[i, j] = key not in seen
            seen.add(key)
    return boxes, labels, torch.from_numpy(first).to(boxes.device)


def match_cost(logits: Tensor, boxes: Tensor, gt_boxes: Tensor, gt_labels: Tensor,
               canvas: Tuple[int, int]) -> Tensor:
    """``[..., N, G]``: focal class cost x 2 + L1 x 5 - GIoU x 2."""
    scale = torch.tensor([canvas[1], canvas[0], canvas[1], canvas[0]], dtype=boxes.dtype,
                         device=boxes.device)
    p = torch.sigmoid(logits)
    pos = ALPHA * (1 - p) ** GAMMA * -torch.log(p + 1e-8)
    neg = (1 - ALPHA) * p ** GAMMA * -torch.log(1 - p + 1e-8)
    idx = gt_labels[..., None, :].expand(*logits.shape[:-1], gt_labels.shape[-1])
    cls = pos.gather(-1, idx) - neg.gather(-1, idx)
    l1 = ((boxes / scale)[..., :, None, :] - (gt_boxes / scale)[..., None, :, :]).abs().sum(-1)
    pair_giou = giou(boxes[..., :, None, :], gt_boxes[..., None, :, :])
    return CLS_W * cls + L1_W * l1 - GIOU_W * pair_giou


def hungarian(cost: np.ndarray) -> np.ndarray:
    """The least-cost assignment of each row to a distinct column (rows <=
    columns) by shortest augmenting paths with row and column potentials:
    the column of each row."""
    n, m = cost.shape
    u, v = np.zeros(n + 1), np.zeros(m + 1)
    owner = np.zeros(m + 1, np.int64)  # owner[j]: the row (1-based) on column j; 0 free
    way = np.zeros(m + 1, np.int64)
    for i in range(1, n + 1):
        owner[0], j0 = i, 0
        dist = np.full(m + 1, np.inf)
        used = np.zeros(m + 1, bool)
        while True:
            used[j0] = True
            reduced = cost[owner[j0] - 1] - u[owner[j0]] - v[1:]
            free = ~used[1:]
            closer = free & (reduced < dist[1:])
            dist[1:][closer] = reduced[closer]
            way[1:][closer] = j0
            candidates = np.where(free, dist[1:], np.inf)
            j1 = int(np.argmin(candidates)) + 1
            delta = candidates[j1 - 1]
            u[owner[used]] += delta
            v[used] -= delta
            dist[1:][free] -= delta
            j0 = j1
            if owner[j0] == 0:
                break
        while j0:
            owner[j0] = owner[way[j0]]
            j0 = way[j0]
    rows = np.zeros(n, np.int64)
    for j in np.flatnonzero(owner[1:]):
        rows[owner[j + 1] - 1] = j
    return rows


def assignments(cost: Tensor, gt_valid: Tensor) -> np.ndarray:
    """``cost`` ``[S, B, N, G]`` -> ``[S, B, G]``: each valid GT's query, -1
    for the rest (and for the valid GTs left over where they outnumber the
    queries)."""
    cost = cost.detach().double().cpu().numpy()
    valid = gt_valid.cpu().numpy().astype(bool)
    out = np.full((cost.shape[0], cost.shape[1], cost.shape[3]), -1, np.int64)
    for s in range(cost.shape[0]):
        for b in range(cost.shape[1]):
            cols = np.flatnonzero(valid[b])
            c = cost[s, b][:, cols]
            if cols.size <= c.shape[0]:
                out[s, b, cols] = hungarian(c.T)
            else:
                out[s, b, cols[hungarian(c)]] = np.arange(c.shape[0])
    return out


def focal_sum(logits: Tensor, target: Tensor) -> Tensor:
    p = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, target, reduction="none")
    weight = torch.where(target > 0, ALPHA, 1 - ALPHA)
    return (weight * ((target - p).abs() + FOCAL_EPS) ** GAMMA * ce).sum()


def set_loss(logits: Tensor, boxes: Tensor, assign: np.ndarray, gt_boxes: Tensor,
             gt_labels: Tensor, gt_valid: Tensor, canvas: Tuple[int, int]) -> Tensor:
    s, b, n, k = logits.shape
    scale = torch.tensor([canvas[1], canvas[0], canvas[1], canvas[0]], dtype=boxes.dtype,
                         device=boxes.device)
    n_gt = gt_valid.sum().clamp_min(1).to(logits.dtype)
    total = 0.0
    for si in range(s):
        target = torch.zeros_like(logits[si])
        l1 = gi = 0.0
        for bi in range(b):
            g = np.flatnonzero(assign[si, bi] >= 0)
            q = torch.from_numpy(assign[si, bi, g]).to(logits.device)
            g = torch.from_numpy(g).to(logits.device)
            target[bi, q, gt_labels[bi, g]] = 1.0
            pb, gb = boxes[si, bi, q], gt_boxes[bi, g]
            l1 = l1 + (pb / scale - gb / scale).abs().sum()
            gi = gi + (1 - giou(pb, gb)).sum()
        total = total + (CLS_W * focal_sum(logits[si], target) + L1_W * l1 + GIOU_W * gi) / n_gt
    return total / s


class AdamW:
    """torch's AdamW (betas 0.9, 0.999, eps 1e-8, decoupled decay) over the
    trainable parameters; a frozen one is never touched."""

    def __init__(self, model: nn.Module, lr: float, weight_decay: float):
        self.params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.lr, self.wd = lr, weight_decay
        self.m = {n: torch.zeros_like(p) for n, p in self.params}
        self.v = {n: torch.zeros_like(p) for n, p in self.params}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        bc1, bc2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for n, p in self.params:
            p.mul_(1 - self.lr * self.wd)
            self.m[n].lerp_(p.grad, 0.1)
            self.v[n].mul_(0.999).addcmul_(p.grad, p.grad, value=0.001)
            p.addcdiv_(self.m[n], self.v[n].sqrt() / math.sqrt(bc2) + 1e-8, value=-self.lr / bc1)


def train_step(model: AdaMixer, opt: AdamW, batch: Dict[str, Tensor],
               assign: Optional[np.ndarray] = None):
    """Forward, the matching (or ``assign``), the set loss, backward, AdamW.
    -> (loss, gradients by name, every stage's logits and boxes, assignments)."""
    for _, p in opt.params:
        p.grad = None
    images = batch["images"]
    canvas = tuple(images.shape[1:3])
    gt_boxes, gt_labels, gt_valid = ground_truth(batch)
    logits, boxes = model(images)
    if assign is None:
        with torch.no_grad():
            assign = assignments(match_cost(logits, boxes, gt_boxes, gt_labels, canvas), gt_valid)
    loss = set_loss(logits, boxes, assign, gt_boxes, gt_labels, gt_valid, canvas)
    loss.backward()
    grads: Dict[str, Tensor] = {}
    for n, p in opt.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads[n] = p.grad
    opt.step()
    return loss.detach(), grads, (logits.detach(), boxes.detach()), assign


def cost_ties(logits: Tensor, boxes: Tensor, batch: Dict[str, Tensor], a: np.ndarray,
              b: np.ndarray, rtol: float) -> List[bool]:
    """For each (stage, image) whose assignments ``a`` and ``b`` differ:
    whether both cost the same under this model's costs, within ``rtol`` of
    the total (a tie that either matching may take)."""
    gt_boxes, gt_labels, _ = ground_truth(batch)
    logits, boxes = logits.to(gt_boxes.device), boxes.to(gt_boxes.device)
    cost = match_cost(logits, boxes, gt_boxes, gt_labels, tuple(batch["images"].shape[1:3]))
    cost = cost.detach().double().cpu().numpy()
    out = []
    for s, i in zip(*np.nonzero((a != b).any(-1))):
        g = np.flatnonzero(a[s, i] >= 0)
        ca, cb = cost[s, i, a[s, i, g], g].sum(), cost[s, i, b[s, i, g], g].sum()
        out.append(bool(abs(ca - cb) <= rtol * max(abs(ca), abs(cb), 1e-12)))
    return out

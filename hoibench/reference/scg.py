"""The SCG HOI network (Zhang, Campbell and Gould, ICCV 2021, arXiv:2012.06060)
as SKGHOI configures it, in plain float32 PyTorch: ResNet-50 + FPN, the
detection filter (score threshold, class-wise greedy NMS, 15 humans + 15
objects), multi-scale RoIAlign by gathers, the graph head with TransH entity
augmentation and MBF message passing, the pair predictor and suppressor, the
three losses, and two-group AdamW with the NaN guard.

It reads a batch as a dict of tensors: ``images [B, H, W, 3]`` in [0, 1],
``image_sizes [B, 2]``, ``det_boxes [B, M, 4]``, ``det_labels [B, M]``,
``det_scores [B, M]``, ``det_valid [B, M]`` and, for training, ``gt_boxes_h``,
``gt_boxes_o [B, G, 4]``, ``gt_object``, ``gt_labels``, ``gt_valid [B, G]``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hoibench.reference.layers import (
    DetectorBackbone,
    Lin,
    Norm,
    Quant,
    bmm_weight,
    identity,
    init_kinds,
)
from hoibench.reference.roi_align import multiscale_roi_align

Tensor = torch.Tensor

HUMAN = 49
N_OBJECTS = 80
N_VERBS = 117
SCORE_THRESH = 0.2
NMS_THRESH = 0.5
MAX_HUMAN = 15
MAX_OBJECT = 15
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
SPATIAL_EPS = 1e-10
FOCAL_ALPHA = 0.5
FOCAL_EPS = 1e-6
TRANSH_CAP = 64
NEG = -1e30


# --- boxes ---------------------------------------------------------------

def box_area(b: Tensor) -> Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def _iou(lt, rb, a1, a2):
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1 + a2 - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)),
                       torch.zeros_like(union))


def box_iou(b1: Tensor, b2: Tensor) -> Tensor:
    lt = torch.maximum(b1[..., :, None, :2], b2[..., None, :, :2])
    rb = torch.minimum(b1[..., :, None, 2:], b2[..., None, :, 2:])
    return _iou(lt, rb, box_area(b1)[..., :, None], box_area(b2)[..., None, :])


def pair_iou(b1: Tensor, b2: Tensor) -> Tensor:
    return _iou(torch.maximum(b1[..., :2], b2[..., :2]), torch.minimum(b1[..., 2:], b2[..., 2:]),
                box_area(b1), box_area(b2))


def nms_keep(boxes: Tensor, scores: Tensor, valid: Tensor, thresh: float) -> Tensor:
    """Greedy NMS, torchvision's rule (suppress at IoU > thresh), stable order."""
    n = boxes.shape[-2]
    order = torch.argsort(-torch.where(valid, scores, torch.full_like(scores, NEG)), dim=-1,
                          stable=True)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    keep = torch.gather(valid, -1, order)
    suppress = box_iou(sboxes, sboxes) > thresh
    earlier = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    for j in range(n):
        keep[..., j] &= ~(keep & earlier[:, j] & suppress[..., :, j]).any(dim=-1)
    return torch.zeros_like(keep).scatter(-1, order, keep)


class Filtered(NamedTuple):
    boxes: Tensor
    labels: Tensor
    scores: Tensor
    n_h: Tensor
    n: Tensor


def filter_detections(boxes, labels, scores, valid, gt: Optional[dict] = None) -> Filtered:
    """Threshold, class-wise NMS (coordinate offsets), score order, 15 humans
    then 15 objects in fixed slots; ground truth joins ahead at score 1."""
    n_slots = MAX_HUMAN + MAX_OBJECT
    if gt is not None:
        gs = gt["gt_valid"].to(scores.dtype)
        boxes = torch.cat([gt["gt_boxes_h"], gt["gt_boxes_o"], boxes], 1)
        scores = torch.cat([gs, gs, scores], 1)
        labels = torch.cat([torch.full_like(gt["gt_object"], HUMAN).to(labels.dtype),
                            gt["gt_object"].to(labels.dtype), labels], 1)
        valid = torch.cat([gt["gt_valid"], gt["gt_valid"], valid], 1)
    valid = valid & (scores >= SCORE_THRESH)
    coords = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    offsets = labels.to(boxes.dtype)[..., None] * (coords.flatten(-2).amax(-1) + 1.0)[..., None, None]
    keep = nms_keep(boxes + offsets, scores, valid, NMS_THRESH)
    order = torch.argsort(-torch.where(keep, scores, torch.full_like(scores, NEG)), dim=-1,
                          stable=True)
    s_boxes = torch.gather(boxes, 1, order[..., None].expand(*order.shape, 4))
    s_labels, s_scores, s_keep = (torch.gather(t, 1, order) for t in (labels, scores, keep))
    is_h = s_keep & (s_labels == HUMAN)
    is_o = s_keep & (s_labels != HUMAN)
    h_rank, o_rank = torch.cumsum(is_h, 1), torch.cumsum(is_o, 1)
    n_h = h_rank[:, -1].clamp_max(MAX_HUMAN)
    n = n_h + o_rank[:, -1].clamp_max(MAX_OBJECT)
    slot = torch.where(is_h & (h_rank <= MAX_HUMAN), h_rank - 1,
                       torch.where(is_o & (o_rank <= MAX_OBJECT), n_h[:, None] + o_rank - 1,
                                   torch.full_like(h_rank, n_slots)))

    def pack(x):
        idx = slot.view(*slot.shape, *([1] * (x.dim() - 2))).expand_as(x)
        return x.new_zeros((x.shape[0], n_slots + 1, *x.shape[2:])).scatter(1, idx, x)[:, :n_slots]

    return Filtered(pack(s_boxes), pack(s_labels), pack(s_scores), n_h, n)


# --- spatial encodings -----------------------------------------------------

def spatial_encodings(b1: Tensor, b2: Tensor, h: Tensor, w: Tensor) -> Tensor:
    """The 23 pairwise box features and their logs, ``[..., 46]``."""
    eps = SPATIAL_EPS
    b1, b2 = torch.broadcast_tensors(b1, b2)
    c1x, c1y = (b1[..., 0] + b1[..., 2]) / 2, (b1[..., 1] + b1[..., 3]) / 2
    c2x, c2y = (b2[..., 0] + b2[..., 2]) / 2, (b2[..., 1] + b2[..., 3]) / 2
    b1w, b1h = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1]
    b2w, b2h = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1]
    dx, dy = (c2x - c1x).abs() / (b1w + eps), (c2y - c1y).abs() / (b1h + eps)
    a1, a2 = b1w * b1h / (h * w), b2w * b2h / (h * w)
    f = torch.stack([
        c1x / w, c1y / h, c2x / w, c2y / h, (c1x / w) / (c2x / w + eps), (c1y / h) / (c2y / h + eps),
        b1w / w, b1h / h, b2w / w, b2h / h, (b1w / w) / (b2w / w + eps), (b1h / h) / (b2h / h + eps),
        a1, a2, a1 / (a2 + eps), b2w * b2h / (b1w * b1h + eps),
        b1w / (b1h + eps), b2w / (b2h + eps), pair_iou(b1, b2),
        (c2x > c1x).float() * dx, (c2x < c1x).float() * dx,
        (c2y > c1y).float() * dy, (c2y < c1y).float() * dy,
    ], -1)
    return torch.nan_to_num(torch.cat([f, torch.log(f + eps)], -1), nan=0.0, posinf=0.0,
                            neginf=0.0)


# --- losses ----------------------------------------------------------------

def focal(x: Tensor, y: Tensor, gamma: float, mask: Tensor) -> Tensor:
    x = x.clamp(FOCAL_EPS, 1.0 - FOCAL_EPS)
    bce = -(y * torch.log(x) + (1.0 - y) * torch.log(1.0 - x))
    loss = (1.0 - y - FOCAL_ALPHA).abs() * ((y - x).abs() + FOCAL_EPS) ** gamma * bce
    return torch.where(mask, loss, torch.zeros((), device=loss.device)).sum()


def focal_logits(z: Tensor, y: Tensor, gamma: float, mask: Tensor) -> Tensor:
    x = torch.sigmoid(z)
    bce = z.clamp_min(0.0) - z * y + torch.log1p(torch.exp(-z.abs()))
    loss = (1.0 - y - FOCAL_ALPHA).abs() * ((y - x).abs() + FOCAL_EPS) ** gamma * bce
    return torch.where(mask, loss, torch.zeros((), device=loss.device)).sum()


def gumbel_noise(shape, generator: torch.Generator, device) -> Tensor:
    """``-log(-log(U))``, U uniform from ``generator`` (clamped to float32's tiny)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


# --- modules ---------------------------------------------------------------

class MBF(nn.Module):
    """``relu?(sum_k fc3_k(relu(fc1_k(a) * fc2_k(s))))``, 16 stacked branches."""

    def __init__(self, a: int, s: int, rep: int, final_relu: bool = True, card: int = 16,
                 quant: Quant = identity):
        super().__init__()
        sub = rep // card
        self.w1 = nn.Parameter(torch.empty(card, a, sub))
        self.b1 = nn.Parameter(torch.empty(card, sub))
        self.w2 = nn.Parameter(torch.empty(card, s, sub))
        self.b2 = nn.Parameter(torch.empty(card, sub))
        self.w3 = nn.Parameter(torch.empty(card, sub, rep))
        self.b3 = nn.Parameter(torch.empty(card, rep))
        self.final_relu, self.quant = final_relu, quant

    def _branches(self, x, w, b):
        k, i, s = w.shape
        return bmm_weight(x, w.permute(1, 0, 2).reshape(i, k * s), self.quant).unflatten(-1, (k, s)) + b

    def forward(self, app: Tensor, spatial: Tensor) -> Tensor:
        h = F.relu(self._branches(app, self.w1, self.b1) * self._branches(spatial, self.w2, self.b2))
        out = bmm_weight(h.flatten(-2), self.w3.flatten(0, 1), self.quant) + self.b3.sum(0)
        return F.relu(out) if self.final_relu else out

    def init_kinds(self) -> dict:
        fans = {"w1": self.w1.shape[1], "b1": self.w1.shape[1], "w2": self.w2.shape[1],
                "b2": self.w2.shape[1], "w3": self.w3.shape[1], "b3": self.w3.shape[1]}
        return {k: ("uniform", f ** -0.5) for k, f in fans.items()}


def _l2n(x: Tensor) -> Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


class TransH(nn.Module):
    def __init__(self, n_ent: int, n_rel: int, dim: int = 50):
        super().__init__()
        self.ent_embeddings = nn.Embedding(n_ent, dim)
        self.rel_embeddings = nn.Embedding(n_rel, dim)
        self.norm_vector = nn.Embedding(n_rel, dim)

    def score(self, h, t, r):
        """L2 distance of (h, r, t) on r's hyperplane, all normalised."""
        re, w = self.rel_embeddings(r), _l2n(self.norm_vector(r))
        hp, tp = (e - (e * w).sum(-1, keepdim=True) * w
                  for e in (self.ent_embeddings(h), self.ent_embeddings(t)))
        d = _l2n(hp) + _l2n(re) - _l2n(tp)
        return torch.sqrt((d * d).sum(-1) + 1e-30)

    def init_kinds(self) -> dict:
        return {f"{n}.weight": ("uniform", math.sqrt(6.0 / sum(e.weight.shape)))
                for n, e in self.named_children()}


def masked_softmax(logits: Tensor, mask: Tensor, dim: int) -> Tensor:
    z = torch.where(mask, logits, torch.full_like(logits, torch.finfo(logits.dtype).min))
    e = torch.exp(z - z.amax(dim=dim, keepdim=True).detach()) * mask.to(logits.dtype)
    return e / e.sum(dim=dim, keepdim=True).clamp_min(1e-20)


class GraphHead(nn.Module):
    def __init__(self, quant: Quant = identity):
        super().__init__()
        lin = lambda i, o: Lin(i, o, quant=quant)  # noqa: E731
        self.box_head_fc1 = lin(256 * 49, 1024)
        self.box_head_fc2 = lin(1024, 1024)
        self.adjacency = lin(1024, 1)
        self.sub_to_obj = MBF(1024, 1024, 1024, final_relu=False, quant=quant)
        self.obj_to_sub = MBF(1024, 1024, 1024, final_relu=False, quant=quant)
        self.norm_h = Norm(1024)
        self.norm_o = Norm(1024)
        self.spatial_fc1 = lin(46, 128)
        self.spatial_fc2 = lin(128, 256)
        self.spatial_fc3 = lin(256, 1024)
        self.attention_head = MBF(2048, 1024, 1024, quant=quant)
        self.attention_head_g = MBF(256, 1024, 1024, quant=quant)
        self.transh = TransH(N_OBJECTS, N_VERBS)
        self.fc_head = lin(1024 + 50, 1024)
        self.fc_tail = lin(1024 + 50, 1024)

    def forward(self, glob, box_feats, boxes, labels, scores, n_h, n, sizes, ovm, gt, gumbel):
        b, ns = boxes.shape[:2]
        h = MAX_HUMAN
        dev = boxes.device
        node = F.relu(self.box_head_fc2(F.relu(self.box_head_fc1(box_feats.flatten(-3)))))
        emb = self.transh.ent_embeddings
        tails = labels.clamp(0, N_OBJECTS - 1)
        h_aug = F.relu(self.fc_head(torch.cat([node[:, :h], emb.weight[HUMAN].expand(b, h, -1)], -1)))
        o_aug = F.relu(self.fc_tail(torch.cat([node, emb(tails)], -1)))
        sp = spatial_encodings(boxes[:, :h, None, :], boxes[:, None, :, :],
                               sizes[:, 0, None, None], sizes[:, 1, None, None])
        sp = F.relu(self.spatial_fc3(F.relu(self.spatial_fc2(F.relu(self.spatial_fc1(sp))))))
        human_ok = torch.arange(h, device=dev)[None, :] < n_h.clamp_max(h)[:, None]
        box_ok = torch.arange(ns, device=dev)[None, :] < n[:, None]
        not_self = torch.arange(h, device=dev)[:, None] != torch.arange(ns, device=dev)[None, :]
        pair_valid = human_ok[:, :, None] & box_ok[:, None, :] & not_self

        app = torch.cat(torch.broadcast_tensors(h_aug[:, :, None, :], o_aug[:, None, :, :]), -1)
        adj = self.adjacency(self.attention_head(app, sp))[..., 0]
        w_row = masked_softmax(adj, box_ok[:, None, :], 2)
        msg_h = F.relu((w_row[..., None] * self.obj_to_sub(o_aug[:, None, :, :], sp)).sum(2))
        new_h = self.norm_h(h_aug + msg_h)
        w_col = masked_softmax(adj.transpose(1, 2), human_ok[:, None, :], 2)
        msg_o = F.relu((w_col.transpose(1, 2)[..., None]
                        * self.sub_to_obj(h_aug[:, :, None, :], sp)).sum(1))
        new_o = self.norm_o(o_aug + msg_o)

        pair_app = torch.cat(torch.broadcast_tensors(new_h[:, :, None, :], new_o[:, None, :, :]), -1)
        feats = torch.cat([self.attention_head(pair_app, sp),
                           self.attention_head_g(glob[:, None, None, :], sp)], -1)
        s = scores ** (1.0 if gt is not None else 2.8)
        verbs = ovm[labels]
        prior = torch.stack(torch.broadcast_tensors(s[:, :h, None, None] * verbs[:, None],
                                                    s[:, None, :, None] * verbs[:, None]), 1)
        prior = prior * pair_valid[:, None, :, :, None]
        out = dict(pair_features=feats, pair_valid=pair_valid, prior=prior)
        if gt is None:
            return out

        iou_h = box_iou(boxes[:, :h], gt["gt_boxes_h"])
        iou_o = box_iou(boxes, gt["gt_boxes_o"])
        hit = ((torch.minimum(iou_h[:, :, None, :], iou_o[:, None, :, :]) >= 0.5)
               & gt["gt_valid"][:, None, None, :])
        onehot = (gt["gt_labels"][..., None] == torch.arange(N_VERBS, device=dev)).float()
        labels_hnk = torch.einsum("bhng,bgk->bhnk", hit.float(), onehot).clamp(0.0, 1.0)
        labels_hnk = labels_hnk * pair_valid[..., None]
        k = N_VERBS
        t = tails[..., None].expand(-1, -1, k)
        box_scores = self.transh.score(torch.full_like(t, HUMAN), t,
                                       torch.arange(k, device=dev).expand_as(t))
        flat_scores = box_scores[:, None].expand(b, h, ns, k).reshape(b, -1)
        flat_labels = labels_hnk.reshape(b, -1)
        pv = pair_valid[..., None].expand_as(labels_hnk).reshape(b, -1)
        n_lab = flat_labels.sum(1)
        top = lambda x: torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :TRANSH_CAP]  # noqa: E731
        pos_idx = top(flat_labels)
        neg_idx = top(torch.where((flat_labels < 0.5) & pv, gumbel, torch.full_like(gumbel, -math.inf)))
        out.update(labels=labels_hnk, unary=labels_hnk.sum(-1).clamp(0.0, 1.0),
                   transh_pos=torch.gather(flat_scores, 1, pos_idx),
                   transh_neg=torch.gather(flat_scores, 1, neg_idx),
                   transh_mask=torch.arange(TRANSH_CAP, device=dev)[None] < n_lab.clamp_max(TRANSH_CAP)[:, None])
        return out


class InteractionHead(nn.Module):
    def __init__(self, quant: Quant = identity):
        super().__init__()
        self.box_pair_head = GraphHead(quant)
        self.box_pair_predictor = Lin(2048, N_VERBS, quant=quant)
        self.box_pair_suppressor = Lin(2048, 1, quant=quant)


class SCG(nn.Module):
    """``forward(batch, ovm, gumbel=None)``: with ``gumbel`` (training, the
    batch has targets) it returns the outputs and the three losses."""

    def __init__(self, frozen_stages: int = 1, quant: Quant = identity):
        super().__init__()
        self.detector = DetectorBackbone(frozen_stages, quant)
        self.interaction_head = InteractionHead(quant)

    def init_kinds(self) -> dict:
        over = {}
        for name, m in self.named_modules():
            if isinstance(m, (MBF, TransH)):
                over.update({f"{name}.{k}": v for k, v in m.init_kinds().items()})
        return init_kinds(self, over)

    def forward(self, batch: Dict[str, Tensor], ovm: Tensor, gumbel: Optional[Tensor] = None):
        dev = batch["images"].device
        images = ((batch["images"] - torch.tensor(MEAN, device=dev)) / torch.tensor(STD, device=dev))
        maps = self.detector(images)
        gt = batch if gumbel is not None else None
        det = filter_detections(batch["det_boxes"], batch["det_labels"], batch["det_scores"],
                                batch["det_valid"], gt)
        box_feats = multiscale_roi_align(maps, det.boxes)
        head = self.interaction_head
        g = head.box_pair_head(maps[3].mean(dim=(1, 2)), box_feats, det.boxes, det.labels,
                               det.scores, det.n_h, det.n, batch["image_sizes"], ovm, gt, gumbel)
        logits_p = head.box_pair_predictor(g["pair_features"])
        logits_s = head.box_pair_suppressor(g["pair_features"])[..., 0]
        prior = g["prior"]
        scores = torch.sigmoid(logits_p) * (prior[:, 0] * prior[:, 1]) * torch.sigmoid(logits_s).detach()[..., None]
        valid = prior[:, 0] > 0
        scores = torch.where(valid, scores, torch.zeros((), device=dev))
        out = dict(scores=scores, boxes=det.boxes, labels=det.labels, n_h=det.n_h, n=det.n)
        if gumbel is None:
            return out
        n_cls = (g["labels"] * valid).sum().clamp_min(1.0)
        n_unary = (g["unary"] * g["pair_valid"]).sum().clamp_min(1.0)
        mask = g["transh_mask"]
        raw = (g["transh_pos"] - g["transh_neg"]).clamp_min(-1.0)
        transh = torch.where(mask, raw + 1.0, torch.zeros((), device=dev)).sum() / mask.float().sum().clamp_min(1.0)
        out["losses"] = dict(
            hoi_loss=focal(scores, g["labels"], 0.2, valid) / n_cls,
            interactiveness_loss=focal_logits(logits_s, g["unary"], 2.0, g["pair_valid"]) / n_unary,
            transh_loss=transh / n_unary)
        return out


# --- the train step ----------------------------------------------------------

class AdamW:
    """torch's AdamW (betas 0.9, 0.999, eps 1e-8, decoupled decay) over two
    groups, ``detector.*`` at ``lr * lr_decay`` and the rest at ``lr``, with
    the lr divided by ``1 / gamma`` once ``milestone_steps`` steps are applied."""

    def __init__(self, model: nn.Module, lr: float, lr_decay: float, weight_decay: float,
                 milestone_steps: int, gamma: float):
        self.params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.scale = {n: (lr_decay if n.startswith("detector.") else 1.0) for n, _ in self.params}
        self.lr, self.wd, self.milestone, self.gamma = lr, weight_decay, milestone_steps, gamma
        self.m = {n: torch.zeros_like(p) for n, p in self.params}
        self.v = {n: torch.zeros_like(p) for n, p in self.params}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        lr0 = self.lr * (self.gamma if self.t >= self.milestone else 1.0)
        self.t += 1
        bc1, bc2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for n, p in self.params:
            lr = lr0 * self.scale[n]
            p.mul_(1 - lr * self.wd)
            self.m[n].lerp_(p.grad, 0.1)
            self.v[n].mul_(0.999).addcmul_(p.grad, p.grad, value=0.001)
            p.addcdiv_(self.m[n], self.v[n].sqrt() / math.sqrt(bc2) + 1e-8, value=-lr / bc1)


def train_step(model: SCG, opt: AdamW, batch: Dict[str, Tensor], ovm: Tensor,
               gumbel: Tensor) -> tuple:
    """Forward, the summed losses, backward, the update when the total and
    every gradient are finite.  -> (total, losses, gradients by name, applied,
    the filter's slots)."""
    for _, p in opt.params:
        p.grad = None
    out = model(batch, ovm, gumbel)
    total = sum(out["losses"].values())
    total.backward()
    grads = {}
    for n, p in opt.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads[n] = p.grad
    applied = bool(torch.isfinite(total) & torch.stack([torch.isfinite(g).all() for g in grads.values()]).all())
    if applied:
        opt.step()
    slots = {k: out[k].detach() for k in ("boxes", "labels", "n_h", "n")}
    return total.detach(), {k: v.detach() for k, v in out["losses"].items()}, grads, applied, slots


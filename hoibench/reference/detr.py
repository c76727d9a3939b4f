"""DETR-R50 (Carion et al., arXiv:2005.12872; facebookresearch/detr's defaults)
in plain float32 PyTorch: the ResNet-50 body (frozen BatchNorm) to C5, a
1x1 projection to 256, sine positions, a post-norm transformer of 6 encoder
and 6 decoder layers (8 heads, FFN 2048), 100 queries, a final decoder norm,
the class head and the 3-layer box MLP (normalised cxcywh).

Images are ``[B, H, W, 3]``, already normalised.  Names follow the
program's module names, so one state dict loads into both.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hoibench.reference.layers import Conv, Lin, Norm, Quant, ResNet50, bmm_weight, identity, init_kinds

Tensor = torch.Tensor

D = 256
HEADS = 8
FFN = 2048


def sine_positions(h: int, w: int) -> np.ndarray:
    """DETR's ``PositionEmbeddingSine`` on a fully valid grid, float64 -> float32."""
    scale, eps, npf = 2 * math.pi, 1e-6, 128
    y = np.broadcast_to(np.arange(1, h + 1, dtype=np.float64)[:, None] / (h + eps) * scale, (h, w))
    x = np.broadcast_to(np.arange(1, w + 1, dtype=np.float64)[None, :] / (w + eps) * scale, (h, w))
    dim_t = 10000.0 ** (2 * (np.arange(npf) // 2) / npf)

    def enc(v):
        p = v[..., None] / dim_t
        return np.stack([np.sin(p[..., 0::2]), np.cos(p[..., 1::2])], -1).reshape(h, w, -1)

    return np.concatenate([enc(y), enc(x)], -1).astype(np.float32)


class MHA(nn.Module):
    def __init__(self, quant: Quant):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * D, D))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * D))
        self.out_proj = Lin(D, D, quant=quant)
        self.quant = quant

    def forward(self, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        w, b, hd, qt = self.in_proj_weight, self.in_proj_bias, D // HEADS, self.quant

        def proj(x, i):
            y = F.linear(qt(x), qt(w[i * D:(i + 1) * D]), b[i * D:(i + 1) * D])
            return y.reshape(x.shape[0], x.shape[1], HEADS, hd).transpose(1, 2)

        qh, kh, vh = proj(q, 0), proj(k, 1), proj(v, 2)
        attn = torch.softmax(bmm_weight(qh, kh.transpose(-1, -2), qt) / math.sqrt(hd), -1)
        out = bmm_weight(attn, vh, qt).transpose(1, 2).reshape(q.shape[0], q.shape[1], D)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    def __init__(self, quant: Quant):
        super().__init__()
        self.self_attn = MHA(quant)
        self.linear1, self.linear2 = Lin(D, FFN, quant=quant), Lin(FFN, D, quant=quant)
        self.norm1, self.norm2 = Norm(D), Norm(D)

    def forward(self, src, pos):
        q = src + pos
        src = self.norm1(src + self.self_attn(q, q, src))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DecoderLayer(nn.Module):
    def __init__(self, quant: Quant):
        super().__init__()
        self.self_attn, self.multihead_attn = MHA(quant), MHA(quant)
        self.linear1, self.linear2 = Lin(D, FFN, quant=quant), Lin(FFN, D, quant=quant)
        self.norm1, self.norm2, self.norm3 = Norm(D), Norm(D), Norm(D)

    def forward(self, tgt, memory, pos, query_pos):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class DETR(nn.Module):
    """``forward(images) -> (logits [B, Q, C + 1], boxes cxcywh [B, Q, 4])``."""

    def __init__(self, num_classes: int = 80, layers: int = 6, queries: int = 100,
                 quant: Quant = identity):
        super().__init__()
        self.body = ResNet50(quant=quant)
        self.input_proj = Conv(2048, D, 1, bias=True, quant=quant)
        self.encoder = nn.ModuleList(EncoderLayer(quant) for _ in range(layers))
        self.decoder = nn.ModuleList(DecoderLayer(quant) for _ in range(layers))
        self.decoder_norm = Norm(D)
        self.query_embed = nn.Parameter(torch.empty(queries, D))
        self.class_embed = Lin(D, num_classes + 1, quant=quant)
        self.bbox_mlp = nn.ModuleList([Lin(D, D, quant=quant), Lin(D, D, quant=quant),
                                       Lin(D, 4, quant=quant)])

    def init_kinds(self) -> dict:
        over = {"query_embed": ("normal", 1.0)}
        for name, m in self.named_modules():
            if isinstance(m, MHA):
                over[f"{name}.in_proj_weight"] = ("normal", D ** -0.5)
                over[f"{name}.in_proj_bias"] = ("uniform", D ** -0.5)
        return init_kinds(self, over)

    def forward(self, images: Tensor):
        feat = self.input_proj(self.body(images.permute(0, 3, 1, 2))[-1])
        b, _, fh, fw = feat.shape
        src = feat.permute(0, 2, 3, 1).reshape(b, fh * fw, D)
        pos = torch.from_numpy(sine_positions(fh, fw)).reshape(1, fh * fw, D).to(src.device)
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
        return self.class_embed(hs), torch.sigmoid(xb)

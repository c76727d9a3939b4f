"""Multi-scale RoIAlign, plain PyTorch gather formulation.

Mirrors ``skghoi_tpu.ops.roi_align`` batched over images: torchvision
``roi_align`` with ``aligned=False`` (the reference's ``MultiScaleRoIAlign``,
``models/adamixer_transH_spatial_r50_models.py:158-162``):

  * RoI corners scaled by ``1/stride``; width/height at least 1 cell,
  * each of the 7x7 bins averages a ``sampling_ratio x sampling_ratio`` grid
    of samples at ``(i + 0.5)/sr`` of the bin,
  * bilinear interpolation is 0 outside ``[-1, size]`` and clamps to the edge
    inside,
  * FPN level per box by torchvision's ``LevelMapper`` (224, 4, [2, 5]).

This is the plain version of the CUDA kernel in ``roi_align_cuda``: the CPU
path, and what the kernel is held against on the card.  Maps are NHWC.

:func:`roi_align_adjoint` is the gradient with respect to the maps, the
counterpart of ``skghoi_tpu/ops/pallas_roi_align.py::_roi_backward``: per
level, ``dF = A_y^T dOut A_x`` as two batched GEMMs over whole-level
interpolation matrices (:func:`level_axis_weights`).  It is the plain version
of the CUDA adjoint kernel that ``roi_align_cuda.RoIAlignFunction`` runs in
its backward: the CPU tests and ``chip_smoke.py`` hold the kernel against it,
and nothing on the card's path calls it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from skghoi_torch.constants import FPN_STRIDES, ROI_POOL_SIZE, ROI_SAMPLING_RATIO

Tensor = torch.Tensor


def fpn_level_assignment(boxes: Tensor, canonical_scale: int = 224, canonical_level: int = 4,
                         k_min: int = 2, k_max: int = 5, eps: float = 1e-6) -> Tensor:
    """torchvision ``LevelMapper``: ``[..., 4]`` boxes -> int32 level in ``[0, k_max-k_min]``."""
    area = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])).clamp_min(0.0)
    lvl = torch.floor(canonical_level + torch.log2(_div(torch.sqrt(area), canonical_scale) + eps))
    return (lvl.clamp(k_min, k_max) - k_min).to(torch.int32)


def _div(x: Tensor, d: float) -> Tensor:
    """``x / d`` rounded once, as the CUDA kernel's ``__fdiv_rn`` does.

    For a Python-number (or CPU 0-dim) divisor torch's CUDA ``div`` multiplies
    by the reciprocal, which differs from true division in the last bit for
    about half of all float32 inputs; a divisor tensor on ``x``'s device makes
    it divide.  On the CPU torch divides either way, so the result there is
    bit-for-bit that of ``x / d``.
    """
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _sample_axis(start: Tensor, roi_len: Tensor, size: int, pooled: int, sr: int):
    """Sample positions of one axis, ``[B, N] -> [B, N, pooled*sr]``, as
    (low index, high index, low weight, high weight, out-of-bounds)."""
    bins = torch.arange(pooled, dtype=torch.float32, device=start.device)
    off = (torch.arange(sr, dtype=torch.float32, device=start.device) + 0.5) / sr
    rel = (bins[:, None] + off[None, :]).reshape(-1)  # bin + (i + .5)/sr, flattened
    pos = start[..., None] + rel * _div(roi_len, pooled)[..., None]
    oob = (pos < -1.0) | (pos > size)
    pos = pos.clamp_min(0.0)
    low = torch.floor(pos).to(torch.int64).clamp_max(size - 1)
    pos = pos.clamp_max(size - 1)
    high = (low + 1).clamp_max(size - 1)
    frac = pos - low.to(pos.dtype)
    return low, high, 1.0 - frac, frac, oob


def roi_align_level(features: Tensor, boxes: Tensor, stride: int,
                    output_size: int = ROI_POOL_SIZE,
                    sampling_ratio: int = ROI_SAMPLING_RATIO) -> Tensor:
    """RoIAlign ``[B, N, 4]`` boxes over one ``[B, H, W, C]`` level ->
    ``[B, N, P, P, C]`` float32."""
    bsz, h, w, _ = features.shape
    p, sr = output_size, sampling_ratio
    scale = 1.0 / stride
    x1 = boxes[..., 0] * scale
    y1 = boxes[..., 1] * scale
    roi_w = (boxes[..., 2] * scale - x1).clamp_min(1.0)
    roi_h = (boxes[..., 3] * scale - y1).clamp_min(1.0)
    yl, yh, hy, ly, oob_y = _sample_axis(y1, roi_h, h, p, sr)  # [B, N, P*sr]
    xl, xh, hx, lx, oob_x = _sample_axis(x1, roi_w, w, p, sr)

    n = boxes.shape[1]
    bidx = torch.arange(bsz, device=boxes.device).view(bsz, 1, 1, 1)
    f = features.float()

    def corner(yi, xi):  # [B, N, P*sr, P*sr, C]
        return f[bidx, yi[:, :, :, None], xi[:, :, None, :]]

    wy_l, wy_h = hy[..., :, None, None], ly[..., :, None, None]
    wx_l, wx_h = hx[..., None, :, None], lx[..., None, :, None]
    val = (
        (wy_l * wx_l) * corner(yl, xl)
        + (wy_l * wx_h) * corner(yl, xh)
        + (wy_h * wx_l) * corner(yh, xl)
        + (wy_h * wx_h) * corner(yh, xh)
    )
    oob = oob_y[..., :, None] | oob_x[..., None, :]
    val = torch.where(oob[..., None], torch.zeros((), device=val.device), val)
    val = val.view(bsz, n, p, sr, p, sr, -1)
    return val.mean(dim=(3, 5))


def multiscale_roi_align(feature_maps: Sequence[Tensor], boxes: Tensor,
                         strides: Sequence[int] = FPN_STRIDES) -> Tensor:
    """RoIAlign ``[B, N, 4]`` boxes over four ``[B, H_l, W_l, C]`` maps, finest
    first -> ``[B, N, 7, 7, C]`` in the maps' dtype.

    Pools every box at every level and keeps the box's assigned level: dense
    and simple, at four times the work of the kernel.
    """
    levels = fpn_level_assignment(boxes)  # [B, N]
    out = None
    for l, (fm, stride) in enumerate(zip(feature_maps, strides)):
        pooled = roi_align_level(fm, boxes, stride)
        sel = (levels == l)[..., None, None, None]
        out = torch.where(sel, pooled, torch.zeros((), device=pooled.device) if out is None else out)
    return out.to(feature_maps[0].dtype)


def level_axis_weights(start: Tensor, roi_len: Tensor, size, window: int,
                       pooled: int = ROI_POOL_SIZE,
                       sampling_ratio: int = ROI_SAMPLING_RATIO) -> Tensor:
    """Interpolation matrix of one axis over whole levels, ``[...] ->
    [..., pooled, window]`` float32: each bin's row holds the bilinear
    weights of its ``sampling_ratio`` samples on the level's cells, averaged
    (zero for a sample outside ``[-1, size]``).  ``size`` (an int, or a
    tensor that broadcasts against ``start[..., None]``) is the level's
    extent; cells from ``size`` to ``window`` get no weight.  ``_axis_weights``
    of the JAX package with ``origin=0`` and ``window=size``."""
    low, high, w_low, w_high, oob = _sample_axis(start, roi_len, size, pooled, sampling_ratio)
    cells = torch.arange(window, device=start.device)
    w = torch.where(oob, torch.zeros((), device=start.device), w_low)[..., None] * (cells == low[..., None])
    w = w + torch.where(oob, torch.zeros((), device=start.device), w_high)[..., None] * (cells == high[..., None])
    return w.unflatten(-2, (pooled, sampling_ratio)).sum(dim=-2) / sampling_ratio


def roi_align_adjoint(map_shapes: Sequence[Sequence[int]], map_dtype: torch.dtype,
                      boxes: Tensor, grad_out: Tensor,
                      strides: Sequence[int] = FPN_STRIDES) -> tuple:
    """Gradient of :func:`multiscale_roi_align` with respect to the four maps.

    ``map_shapes`` are the ``[B, H_l, W_l, C]`` shapes, ``grad_out`` the
    ``[B, N, 7, 7, C]`` cotangent.  Per level, ``t = A_x^T g``
    (``[B, N, 7, W, C]``) and ``dF = A_y^T t`` summed over the boxes and
    bins (``[B, H, W, C]``): two batched GEMMs, in float32 on the float32
    cotangent, cast to ``map_dtype`` at the end, as ``_roi_backward`` does.
    Boxes assigned to another level contribute nothing (their ``A_y`` rows
    are zeroed, where JAX zeroes their cotangent: the same sum).  The
    interpolation matrices of all levels and both axes come from one
    vectorised pass.  Only the boxes and the shapes are needed, never the
    map values; the boxes get no gradient.
    """
    bsz, n = boxes.shape[:2]
    p = grad_out.shape[2]
    n_levels = len(strides)
    dev = boxes.device
    g = grad_out.float()
    # Strides and level extents in one copy; pinned, because a copy from
    # pageable memory waits for the stream to drain.
    consts = torch.tensor([*strides, *(s[1] for s in map_shapes), *(s[2] for s in map_shapes)])
    consts = (consts.pin_memory() if dev.type == "cuda" else consts).to(dev, non_blocking=True)
    stride = consts[:n_levels].float().view(1, n_levels, 1, 1)
    sizes = consts[n_levels:].view(2, n_levels, 1, 1, 1)  # [axis (y, x), level]
    # [y1, x1, y2, x2] of every box on every level: [4, L, B, N].
    corners = boxes.unflatten(-1, (2, 2)).flip(-1).flatten(-2).permute(2, 0, 1)[:, None] / stride
    start, roi_len = corners[:2], (corners[2:] - corners[:2]).clamp_min(1.0)
    window = max(max(s[1], s[2]) for s in map_shapes)
    weights = level_axis_weights(start, roi_len, sizes, window, p)  # [2, L, B, N, 7, window]
    levels = fpn_level_assignment(boxes)
    on_level = levels == torch.arange(n_levels, device=dev)[:, None, None]  # [L, B, N]
    ay = weights[0] * on_level[..., None, None]
    grads = []
    for l, (_, h, w, c) in enumerate(map_shapes):
        ax = weights[1, l, ..., :w]  # [B, N, 7q, W]
        # t[b, n, p] = A_x[b, n]^T @ g[b, n, p]: [W, 7q] @ [7q, C]
        t = torch.matmul(ax.transpose(-1, -2)[:, :, None], g)  # [B, N, 7p, W, C]
        # dF[b] = sum over (n, p) of A_y[b, n, p]^T t[b, n, p]: [H, N*7] @ [N*7, W*C]
        a = ay[l, ..., :h].reshape(bsz, n * p, h)
        dfm = torch.matmul(a.transpose(1, 2), t.reshape(bsz, n * p, w * c))
        grads.append(dfm.view(bsz, h, w, c).to(map_dtype))
    return tuple(grads)

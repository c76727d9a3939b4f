"""Image preprocessing on the device: raw uint8 -> resized, mean-filled canvas.

Mirrors ``skghoi_tpu.data.device_preprocess`` (XLA there, plain PyTorch
here).  The host keeps only the JPEG decode and a pad into a static raw
canvas; the bilinear resize and the canvas fill run on the device, and the
host-to-device copy carries uint8, a quarter of a float32 canvas.

The arithmetic is ``transforms.bilinear_resize``'s (``F.interpolate(mode=
'bilinear', align_corners=False, antialias=False)``): the half-pixel source
grid, the edge clamp, 2x2 interpolation, each image with its own (h, w) ->
(nh, nw) under the static canvas shape.
"""

from __future__ import annotations

from typing import Tuple

import torch

from skghoi_torch import constants as C
from skghoi_torch.data.structures import HOIBatch

Tensor = torch.Tensor


def _axis_gather(n_out: int, in_n: Tensor, out_n: Tensor):
    """Source taps ``[B, n_out]`` for every index of a static canvas axis,
    from per-image sizes ``in_n``, ``out_n`` ``[B]``; indices at or beyond
    ``out_n`` are in range but unused (the caller masks them)."""
    idx = torch.arange(n_out, dtype=torch.float64, device=in_n.device)
    # The float32 ratio times the position, less 0.5, rounded once: what the
    # reference's fused multiply-add gives (float64 holds the product exactly).
    src = ((idx + 0.5) * (in_n / out_n).double()[:, None] - 0.5).float()
    src = torch.minimum(src.clamp_min(0.0), (in_n - 1.0)[:, None])
    lo = torch.floor(src)
    hi = torch.minimum(lo + 1.0, (in_n - 1.0)[:, None])
    return lo.long(), hi.long(), src - lo


def device_resize_canvas(raw: Tensor, original_sizes: Tensor, image_sizes: Tensor,
                         canvas: Tuple[int, int]) -> Tensor:
    """``raw`` ``[B, Hr, Wr, 3]`` (uint8, or float in [0, 1]) -> ``[B, ch, cw,
    3]`` float32: each image's valid ``original_sizes`` (h, w) region
    bilinearly resized to its ``image_sizes`` (nh, nw) and pasted top-left;
    the rest is the ImageNet mean pixel."""
    ch, cw = canvas
    bsz, _, wr, _ = raw.shape
    scaled = raw.float()
    if raw.dtype == torch.uint8:
        scaled = scaled / 255.0
    h, w = original_sizes.float().unbind(-1)
    nh, nw = image_sizes.float().unbind(-1)
    y0, y1, fy = _axis_gather(ch, h, nh)  # [B, ch]
    x0, x1, fx = _axis_gather(cw, w, nw)  # [B, cw]

    def rows(idx):  # [B, ch, Wr, 3]
        return torch.gather(scaled, 1, idx[:, :, None, None].expand(bsz, ch, wr, 3))

    r = rows(y0) * (1.0 - fy)[..., None, None] + rows(y1) * fy[..., None, None]

    def cols(idx):  # [B, ch, cw, 3]
        return torch.gather(r, 2, idx[:, None, :, None].expand(bsz, ch, cw, 3))

    out = cols(x0) * (1.0 - fx)[:, None, :, None] + cols(x1) * fx[:, None, :, None]
    iy = torch.arange(ch, dtype=torch.float32, device=raw.device)
    ix = torch.arange(cw, dtype=torch.float32, device=raw.device)
    valid = (iy[None, :, None] < nh[:, None, None]) & (ix[None, None, :] < nw[:, None, None])
    # Filled on the device: a host tensor copied from pageable memory would
    # wait for the stream to drain.
    mean = torch.stack([torch.full((), m, device=raw.device) for m in C.IMAGE_MEAN])
    return torch.where(valid[..., None], out, mean)


def prepare_batch(batch: HOIBatch, factory) -> HOIBatch:
    """Resize a raw uint8 batch (``DataFactory(device_resize=True)``) on its
    device into the float canvas the model takes; float batches pass
    through.  The target canvas is the factory's, by the raw batch's
    orientation (both canvases share the h > w rule)."""
    if batch.images.dtype != torch.uint8:
        return batch
    canvas = (factory.canvas_landscape if batch.images.shape[1] <= batch.images.shape[2]
              else factory.canvas_portrait)
    images = device_resize_canvas(batch.images, batch.original_sizes, batch.image_sizes, canvas)
    return batch._replace(images=images)

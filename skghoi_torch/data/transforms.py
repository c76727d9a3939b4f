"""Host-side image and box transforms (decoded image -> resized canvas).

Mirrors ``skghoi_tpu.data.transforms`` (the reference's
``HOINetworkTransform``, torchvision ``GeneralizedRCNNTransform``): scale so
the short side reaches 800 without the long side passing 1333, resize
bilinearly exactly as ``F.interpolate(mode='bilinear', align_corners=False,
antialias=False)`` does, and paste into one of two fixed canvases by
orientation (landscape 832x1344, portrait 1344x832), filled with the ImageNet
mean pixel so the padding normalises to zero on the device.

Images here are decoded ``[H, W, 3]`` uint8 arrays (``HICODet.load_image``
decodes), so nothing below needs an image library.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from skghoi_torch import constants as C


def bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``F.interpolate(img, size, mode='bilinear', align_corners=False)`` in
    numpy: source position ``(i + 0.5) * in/out - 0.5`` clamped to the edge,
    2x2 neighbour interpolation, no antialiasing.  ``img``: [H, W, C] float."""
    in_h, in_w = img.shape[:2]
    img = np.asarray(img, np.float32)

    def axis_coords(out_n, in_n):
        src = (np.arange(out_n, dtype=np.float64) + 0.5) * (in_n / out_n) - 0.5
        src = np.clip(src, 0.0, in_n - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, in_n - 1)
        frac = (src - lo).astype(np.float32)
        return lo, hi, frac

    y0, y1, fy = axis_coords(out_h, in_h)
    x0, x1, fx = axis_coords(out_w, in_w)
    top = img[y0][:, x0] * (1 - fx)[None, :, None] + img[y0][:, x1] * fx[None, :, None]
    bot = img[y1][:, x0] * (1 - fx)[None, :, None] + img[y1][:, x1] * fx[None, :, None]
    return top * (1 - fy)[:, None, None] + bot * fy[:, None, None]


def resize_scale(height: int, width: int, min_size: int = C.IMAGE_MIN_SIZE,
                 max_size: int = C.IMAGE_MAX_SIZE) -> float:
    """torchvision's scale rule (reference ``transforms.py:32-38``)."""
    short, long = float(min(height, width)), float(max(height, width))
    return min(min_size / short, max_size / long)


def resized_size(height: int, width: int, scale: float) -> Tuple[int, int]:
    """Output size under ``F.interpolate(scale_factor=..., recompute_scale_factor=True)``."""
    return int(np.floor(height * scale)), int(np.floor(width * scale))


def canvas_for(height: int, width: int, landscape: Tuple[int, int] = C.CANVAS_LANDSCAPE,
               portrait: Tuple[int, int] = C.CANVAS_PORTRAIT) -> Tuple[int, int]:
    """The fixed canvas of an image's orientation."""
    return portrait if height > width else landscape


def prepare_image(image: np.ndarray, canvas: Tuple[int, int], min_size: int = C.IMAGE_MIN_SIZE,
                  max_size: int = C.IMAGE_MAX_SIZE) -> Tuple[np.ndarray, Tuple[int, int], float]:
    """Resize a decoded ``[H, W, 3]`` uint8 image and paste it top-left into
    ``canvas``.  Returns (float32 ``[Hc, Wc, 3]`` in [0, 1], (new_h, new_w),
    scale); the rest of the canvas is the ImageNet mean pixel."""
    h, w = image.shape[:2]
    scale = resize_scale(h, w, min_size, max_size)
    nh, nw = resized_size(h, w, scale)
    nh, nw = min(nh, canvas[0]), min(nw, canvas[1])
    resized = bilinear_resize(np.asarray(image, np.float32) / 255.0, nh, nw)
    out = np.empty((canvas[0], canvas[1], 3), np.float32)
    out[:] = np.asarray(C.IMAGE_MEAN, np.float32)
    out[:nh, :nw] = resized
    return out, (nh, nw), scale


def scale_boxes(boxes: np.ndarray, orig_size: Tuple[int, int],
                new_size: Tuple[int, int]) -> np.ndarray:
    """Map boxes between coordinate spaces (torchvision ``resize_boxes``)."""
    oh, ow = orig_size
    nh, nw = new_size
    out = np.asarray(boxes, np.float32).copy()
    if len(out) == 0:
        return out.reshape(0, 4)
    out[:, 0::2] *= nw / ow
    out[:, 1::2] *= nh / oh
    return out


def hflip_image_and_boxes(image: np.ndarray, *box_arrays):
    """Horizontal flip of an ``[H, W, 3]`` image and of (x1, y1, x2, y2)
    boxes in its frame (reference ``utils.py:115-143``)."""
    w = image.shape[1]
    outs = []
    for boxes in box_arrays:
        b = np.asarray(boxes, np.float32).copy().reshape(-1, 4)
        x1 = b[:, 0].copy()
        b[:, 0] = w - b[:, 2]
        b[:, 2] = w - x1
        outs.append(b)
    return np.ascontiguousarray(image[:, ::-1]), outs

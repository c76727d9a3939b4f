"""Fixed-shape batch containers, as tensors on one device.

Mirrors ``skghoi_tpu.data.structures``: everything is padded to static
shapes and validity masks carry the ragged structure.  Boxes are already in
the resized-canvas coordinate space.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class HOITargets(NamedTuple):
    """Padded ground-truth box pairs (keys mirror the reference targets)."""

    boxes_h: Tensor  # [B, G, 4]
    boxes_o: Tensor  # [B, G, 4]
    object: Tensor  # [B, G] object class of the object box
    labels: Tensor  # [B, G] verb class of the pair
    valid: Tensor  # [B, G] bool

    def as_dict(self) -> dict:
        return self._asdict()


class HOIBatch(NamedTuple):
    images: Tensor  # [B, Hc, Wc, 3] float in [0, 1], padded canvas
    image_sizes: Tensor  # [B, 2] (h, w) of the resized image inside the canvas
    original_sizes: Tensor  # [B, 2] (h, w) pre-resize, for output rescaling
    det_boxes: Tensor  # [B, M, 4] cached detections in canvas space
    det_labels: Tensor  # [B, M] int64
    det_scores: Tensor  # [B, M]
    det_valid: Tensor  # [B, M] bool
    targets: Optional[HOITargets] = None

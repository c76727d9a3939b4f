"""Pairwise spatial-ratio encodings (46-d) for human-object box pairs.

Mirrors ``skghoi_tpu.ops.spatial``: the reference's 23 geometric features
(``ops.py:85-157``) and their ``log(f + eps)``, batched over any broadcastable
leading dims, in float32, with the reference's ``nan_to_num`` guard built in
so padded zero boxes give finite encodings.
"""

from __future__ import annotations

import torch

from skghoi_torch.constants import SPATIAL_EPS, SPATIAL_FEATURE_SIZE
from skghoi_torch.ops.boxes import elementwise_box_iou

Tensor = torch.Tensor


def compute_spatial_ratio_encodings(
    boxes_1: Tensor,
    boxes_2: Tensor,
    image_heights: Tensor,
    image_widths: Tensor,
    eps: float = SPATIAL_EPS,
) -> Tensor:
    """``[..., 4]`` human and object boxes -> ``[..., 46]`` float32 encodings,
    in the order of reference ``ops.py:134-156``.  Image sizes broadcast to the
    leading dims."""
    b1, b2 = torch.broadcast_tensors(boxes_1.float(), boxes_2.float())
    h = torch.as_tensor(image_heights, dtype=torch.float32, device=b1.device)
    w = torch.as_tensor(image_widths, dtype=torch.float32, device=b1.device)

    c1_x = (b1[..., 0] + b1[..., 2]) / 2
    c1_y = (b1[..., 1] + b1[..., 3]) / 2
    c2_x = (b2[..., 0] + b2[..., 2]) / 2
    c2_y = (b2[..., 1] + b2[..., 3]) / 2

    b1_w = b1[..., 2] - b1[..., 0]
    b1_h = b1[..., 3] - b1[..., 1]
    b2_w = b2[..., 2] - b2[..., 0]
    b2_h = b2[..., 3] - b2[..., 1]

    d_x = torch.abs(c2_x - c1_x) / (b1_w + eps)
    d_y = torch.abs(c2_y - c1_y) / (b1_h + eps)

    iou = elementwise_box_iou(b1, b2)

    c1_xw = c1_x / w
    c1_yh = c1_y / h
    c2_xw = c2_x / w
    c2_yh = c2_y / h
    b1_ww = b1_w / w
    b1_hh = b1_h / h
    b2_ww = b2_w / w
    b2_hh = b2_h / h
    box1_area = b1_w * b1_h / (h * w)
    box2_area = b2_w * b2_h / (h * w)
    box1_ratio = b1_w / (b1_h + eps)
    box2_ratio = b2_w / (b2_h + eps)

    f = torch.stack(
        [
            # Relative position of box centres
            c1_xw,
            c1_yh,
            c2_xw,
            c2_yh,
            c1_xw / (c2_xw + eps),
            c1_yh / (c2_yh + eps),
            # Relative box width and height
            b1_ww,
            b1_hh,
            b2_ww,
            b2_hh,
            b1_ww / (b2_ww + eps),
            b1_hh / (b2_hh + eps),
            # Relative box area
            box1_area,
            box2_area,
            box1_area / (box2_area + eps),
            b2_w * b2_h / (b1_w * b1_h + eps),
            # Box aspect ratio
            box1_ratio,
            box2_ratio,
            # Intersection over union
            iou,
            # Relative distance and direction of the object w.r.t. the person
            (c2_x > c1_x).float() * d_x,
            (c2_x < c1_x).float() * d_x,
            (c2_y > c1_y).float() * d_y,
            (c2_y < c1_y).float() * d_y,
        ],
        dim=-1,
    )

    out = torch.cat([f, torch.log(f + eps)], dim=-1)
    out = torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)
    assert out.shape[-1] == SPATIAL_FEATURE_SIZE
    return out

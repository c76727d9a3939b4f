"""Overlay a raw detection-cache JSON on its image.

    python -m skghoi_torch.tools.visualise_detections \
        --data-root hicodet --detection-root detections/train2015 \
        --image-idx 0 --out-file result.jpg [--cpu]

Mirrors ``skghoi_tpu.tools.visualise_detections`` (reference
``hicodet/detections/visualise.py``): load one image and its cached
``{boxes, labels, scores}`` JSON, drop low-scoring boxes, NMS, and draw
``score label`` text per kept box.  Class names come from the port's
``data/hico_meta.py``; NMS is :func:`skghoi_torch.ops.boxes.nms_keep`
(torchvision semantics), which runs on ``cuda`` unless ``--cpu`` is given,
and raises without a card.  :func:`kept_detections` computes, :func:`draw`
draws with Pillow.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description="Visualize object detections")
    p.add_argument("--detection-root", type=str, required=True)
    p.add_argument("--image-idx", type=int, default=0)
    p.add_argument("--out-file", type=str, default="result.jpg")
    p.add_argument("--data-root", type=str, default="./")
    p.add_argument("--partition", type=str, default="train2015")
    p.add_argument("--box-score-thresh", type=float, default=0.3)
    p.add_argument("--nms-thresh", type=float, default=0.5)
    p.add_argument("--cpu", action="store_true")
    return p


def kept_detections(det: dict, box_score_thresh: float, nms_thresh: float, device):
    """``(boxes, scores, labels)`` of a cache entry that pass the score
    threshold and survive NMS on ``device``, as numpy arrays."""
    import torch

    from skghoi_torch.ops.boxes import nms_keep

    boxes = np.asarray(det["boxes"], np.float32).reshape(-1, 4)
    scores = np.asarray(det["scores"], np.float32).reshape(-1)
    labels = np.asarray(det["labels"], np.int64).reshape(-1)
    keep = scores >= box_score_thresh
    boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
    if len(boxes):
        mask = nms_keep(torch.from_numpy(boxes).to(device), torch.from_numpy(scores).to(device),
                        torch.ones(len(boxes), dtype=torch.bool, device=device), nms_thresh)
        mask = mask.cpu().numpy()
        boxes, scores, labels = boxes[mask], scores[mask], labels[mask]
    return boxes, scores, labels


def draw(image, boxes, scores, labels):
    """``score label`` over each box, on the PIL ``image`` in place."""
    from PIL import ImageDraw

    from skghoi_torch.data.hico_meta import HICO_OBJECTS

    canvas = ImageDraw.Draw(image)
    for b, s, l in zip(boxes, scores, labels):
        canvas.rectangle(b.tolist())
        canvas.text(b[:2].tolist(), f"{str(float(s))[:4]} {HICO_OBJECTS[int(l)]}")
    return image


def main(argv=None):
    """Returns the kept ``(boxes, scores, labels)``."""
    args = build_argparser().parse_args(argv)

    from PIL import Image

    from skghoi_torch.data.hicodet import HICODet
    from skghoi_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    image_dir = os.path.join(args.data_root, f"hico_20160224_det/images/{args.partition}")
    dataset = HICODet(
        root=image_dir,
        anno_file=os.path.join(args.data_root, f"instances_{args.partition}.json"),
    )
    name = dataset.filename(args.image_idx)
    print("Image name: ", name)
    image = Image.open(os.path.join(image_dir, name)).convert("RGB")
    with open(os.path.join(args.detection_root, name.replace(".jpg", ".json"))) as f:
        det = json.load(f)

    kept = kept_detections(det, args.box_score_thresh, args.nms_thresh, device)
    draw(image, *kept).save(args.out_file)
    print(f"Saved {args.out_file} ({len(kept[0])} boxes)")
    return kept


if __name__ == "__main__":
    main()

"""Detection-cache generation (stage 1 of the two-stage pipeline).

Mirrors ``skghoi_tpu.detect.generate`` and writes the same JSON bytes.  The
pipeline consumes per-image JSON files ``{boxes, labels, scores}``
(contract: reference ``hicodet/detections/preprocessing.py:53-75``).  Caches
can come from any detector; this module provides:

- :func:`generate_gt_detections` — GT boxes re-emitted as perfect detections
  with score 1.0 (reference ``generate_gt_detections.py:19-56``), the upper
  bound / debugging cache;
- :func:`generate_model_detections` — run a detector callable (e.g. the
  Faster R-CNN of ``tools/preprocess_detections``) over the dataset and
  cache its outputs in original-image coordinates.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np


def generate_gt_detections(dataset, cache_dir: str, human_idx: int = 49) -> str:
    """Write GT boxes as detections (score 1.0) for every annotated image."""
    os.makedirs(cache_dir, exist_ok=True)
    for i in range(len(dataset._anno)):
        anno = dataset._anno[i]
        fname = dataset._filenames[i]
        npairs = len(anno["boxes_h"])
        boxes = np.asarray(
            list(anno["boxes_h"]) + list(anno["boxes_o"]), np.float64
        ).reshape(-1, 4)
        # pixel indices -> coordinates (reference :34-37)
        boxes[:, :2] -= 1
        labels = [human_idx] * npairs + list(anno["object"])
        scores = [1.0] * (2 * npairs)
        with open(os.path.join(cache_dir, fname.replace(".jpg", ".json")), "w") as f:
            json.dump(dict(boxes=boxes.tolist(), labels=labels, scores=scores), f)
    return cache_dir


def generate_model_detections(
    detector: Callable,
    dataset,
    cache_dir: str,
    score_thresh: float = 0.05,
    label_map: Optional[dict] = None,
) -> str:
    """Cache a detector's outputs per image.

    ``detector(image_array[H, W, 3] float in [0,1]) -> (boxes[N,4],
    labels[N], scores[N])`` in original-image coordinates.  ``label_map``
    optionally remaps detector class ids (e.g. COCO->HICO,
    ``preprocessing.py:59-60``); unmapped classes are dropped.
    """
    os.makedirs(cache_dir, exist_ok=True)
    for i in range(len(dataset)):
        image, _ = dataset[i]
        arr = np.asarray(image, np.float32) / 255.0
        boxes, labels, scores = detector(arr)
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        labels = np.asarray(labels).reshape(-1)
        scores = np.asarray(scores, np.float64).reshape(-1)
        keep = scores >= score_thresh
        boxes, labels, scores = boxes[keep], labels[keep], scores[keep]
        if label_map is not None:
            mapped = np.asarray([label_map.get(str(int(l)), -1) for l in labels])
            keep = mapped >= 0
            boxes, labels, scores = boxes[keep], mapped[keep], scores[keep]
        with open(
            os.path.join(cache_dir, dataset.filename(i).replace(".jpg", ".json")), "w"
        ) as f:
            json.dump(
                dict(
                    boxes=boxes.tolist(),
                    labels=[int(l) for l in labels],
                    scores=scores.tolist(),
                ),
                f,
            )
    return cache_dir

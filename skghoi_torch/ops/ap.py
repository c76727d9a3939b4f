"""Average-precision meters and box(-pair) association, replacing ``pocket``.

The reference evaluates with ``pocket.utils.DetectionAPMeter`` (600 classes,
11-point interpolation, per-class GT counts) and ``BoxPairAssociation``
(min-IoU 0.5 greedy matching) — ``utils.py:148-198``; detection-quality eval
uses the 'INT' (area-under-PR) algorithm (``hicodet/detections/
eval_detections.py:30-32``).  These are host-side bookkeeping over scalar
streams, so they are plain numpy here; the heavy scoring stays on device.
A copy of ``skghoi_tpu.ops.ap``.

Semantics:

- ``DetectionAPMeter.append(scores, classes, labels)`` accumulates per-class
  (score, binary-label) pairs; ``eval()`` returns per-class AP.
- recall denominator = ``num_gt[class]`` when provided, else the number of
  positive labels seen for the class.
- '11P': AP = mean over recall thresholds {0.0, 0.1, ..., 1.0} of the max
  precision at recall >= t (PASCAL VOC 2007).
- 'INT': area under the precision-envelope PR curve (VOC 2010+ / AUC).
- ``BoxPairAssociation``: detections sorted by descending score greedily claim
  the best still-unmatched GT pair with ``min(IoU_h, IoU_o) >= min_iou``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _np_box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def ap_from_pr(precision: np.ndarray, recall: np.ndarray, algorithm: str = "11P") -> float:
    """AP from (precision, recall) curves sorted by descending score."""
    if len(precision) == 0:
        return 0.0
    if algorithm == "11P":
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            mask = recall >= t
            ap += np.max(precision[mask]) / 11 if mask.any() else 0.0
        return float(ap)
    if algorithm == "INT":
        # precision envelope + area
        mrec = np.concatenate([[0.0], recall, [recall[-1]]])
        mpre = np.concatenate([[0.0], precision, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    raise ValueError(f"Unknown AP algorithm {algorithm}")


def average_precision(
    scores: np.ndarray, labels: np.ndarray, num_gt: Optional[int], algorithm: str = "11P"
) -> float:
    """AP of one class from scores + binary TP labels."""
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    labels = np.asarray(labels, np.float64)[order]
    tp = np.cumsum(labels)
    fp = np.cumsum(1.0 - labels)
    denom = num_gt if num_gt is not None else labels.sum()
    if denom == 0:
        return 0.0
    recall = tp / denom
    precision = tp / np.maximum(tp + fp, 1e-12)
    return ap_from_pr(precision, recall, algorithm)


class DetectionAPMeter:
    """Per-class AP accumulator (pocket ``DetectionAPMeter`` surface)."""

    def __init__(
        self,
        num_cls: int,
        num_gt: Optional[Sequence[int]] = None,
        algorithm: str = "11P",
        nproc: int = 1,
    ):
        self.num_cls = num_cls
        self.num_gt = list(num_gt) if num_gt is not None else None
        self.algorithm = algorithm
        self._scores: List[List[float]] = [[] for _ in range(num_cls)]
        self._labels: List[List[float]] = [[] for _ in range(num_cls)]

    def append(self, scores, classes, labels) -> None:
        scores = np.asarray(scores, np.float64).reshape(-1)
        classes = np.asarray(classes).reshape(-1).astype(np.int64)
        labels = np.asarray(labels, np.float64).reshape(-1)
        for c in np.unique(classes):
            sel = classes == c
            self._scores[c].extend(scores[sel].tolist())
            self._labels[c].extend(labels[sel].tolist())

    def reset(self) -> None:
        self._scores = [[] for _ in range(self.num_cls)]
        self._labels = [[] for _ in range(self.num_cls)]

    def eval(self) -> np.ndarray:
        """Per-class AP vector ``[num_cls]``."""
        out = np.zeros(self.num_cls)
        for c in range(self.num_cls):
            gt = self.num_gt[c] if self.num_gt is not None else None
            out[c] = average_precision(
                np.asarray(self._scores[c]), np.asarray(self._labels[c]), gt, self.algorithm
            )
        return out


class BoxPairAssociation:
    """Greedy GT association for (human, object) box pairs."""

    def __init__(self, min_iou: float = 0.5):
        self.min_iou = min_iou

    def __call__(
        self,
        gt_pairs: Tuple[np.ndarray, np.ndarray],
        det_pairs: Tuple[np.ndarray, np.ndarray],
        scores: np.ndarray,
    ) -> np.ndarray:
        gt_h, gt_o = (np.asarray(x, np.float64).reshape(-1, 4) for x in gt_pairs)
        det_h, det_o = (np.asarray(x, np.float64).reshape(-1, 4) for x in det_pairs)
        scores = np.asarray(scores, np.float64).reshape(-1)
        labels = np.zeros(len(scores))
        if len(gt_h) == 0 or len(det_h) == 0:
            return labels
        pair_iou = np.minimum(_np_box_iou(det_h, gt_h), _np_box_iou(det_o, gt_o))
        taken = np.zeros(len(gt_h), bool)
        for i in np.argsort(-scores, kind="stable"):
            ious = np.where(taken, -1.0, pair_iou[i])
            j = int(np.argmax(ious))
            if ious[j] >= self.min_iou:
                labels[i] = 1.0
                taken[j] = True
        return labels


class BoxAssociation(BoxPairAssociation):
    """Single-box variant (detection-quality eval)."""

    def __call__(self, gt_boxes: np.ndarray, det_boxes: np.ndarray, scores: np.ndarray) -> np.ndarray:
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        det_boxes = np.asarray(det_boxes, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64).reshape(-1)
        labels = np.zeros(len(scores))
        if len(gt_boxes) == 0 or len(det_boxes) == 0:
            return labels
        iou = _np_box_iou(det_boxes, gt_boxes)
        taken = np.zeros(len(gt_boxes), bool)
        for i in np.argsort(-scores, kind="stable"):
            ious = np.where(taken, -1.0, iou[i])
            j = int(np.argmax(ious))
            if ious[j] >= self.min_iou:
                labels[i] = 1.0
                taken[j] = True
        return labels

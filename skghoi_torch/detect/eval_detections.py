"""Detection-quality evaluation against HICO-DET ground truth, on host numpy.

Mirrors ``skghoi_tpu.detect.eval_detections``, which reimplements
``hicodet/detections/eval_detections.py:22-136``: per image, threshold
human/object scores separately, class-wise NMS, sort, cap at
``max_human``/``max_object``; NMS the GT boxes too (objects repeat across
pairs) and count them as the per-class denominators; associate per class at
min-IoU 0.5 and feed an 80-class 'INT' AP meter.  Reports mAP and mean max
recall.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from skghoi_torch import constants as C
from skghoi_torch.ops.ap import BoxAssociation, DetectionAPMeter, _np_box_iou


def _np_batched_nms(boxes, scores, labels, thresh):
    keep = []
    for c in np.unique(labels):
        idx = np.nonzero(labels == c)[0]
        order = idx[np.argsort(-scores[idx], kind="stable")]
        taken = []
        for i in order:
            ok = all(_np_box_iou(boxes[i : i + 1], boxes[j : j + 1])[0, 0] <= thresh for j in taken)
            if ok:
                taken.append(i)
        keep.extend(taken)
    return np.asarray(sorted(keep, key=lambda i: -scores[i]), np.int64)


def compute_detection_map(
    dataset,
    detection_dir: str,
    h_thresh: float = 0.2,
    o_thresh: float = 0.2,
    nms_thresh: float = 0.5,
    max_human: int = C.MAX_HUMAN,
    max_object: int = C.MAX_OBJECT,
    human_idx: int = C.HICO_HUMAN_IDX,
    min_iou: float = 0.5,
) -> Dict[str, float]:
    num_gt = np.zeros(C.HICO_NUM_OBJECTS)
    associate = BoxAssociation(min_iou=min_iou)
    meter = DetectionAPMeter(C.HICO_NUM_OBJECTS, algorithm="INT")
    max_recall_tp = np.zeros(C.HICO_NUM_OBJECTS)

    for i in range(len(dataset)):
        target = dataset.raw_target(i)
        path = os.path.join(detection_dir, dataset.filename(i).replace(".jpg", ".json"))
        with open(path) as f:
            det = json.load(f)
        boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
        labels = np.asarray(det["labels"]).reshape(-1)
        scores = np.asarray(det["scores"], np.float64).reshape(-1)

        is_h = labels == human_idx
        keep = (is_h & (scores >= h_thresh)) | (~is_h & (scores >= o_thresh))
        boxes, labels, scores = boxes[keep], labels[keep], scores[keep]
        if len(boxes):
            keep = _np_batched_nms(boxes, scores, labels, nms_thresh)
            boxes, labels, scores = boxes[keep], labels[keep], scores[keep]
            h_sel = np.nonzero(labels == human_idx)[0][:max_human]
            o_sel = np.nonzero(labels != human_idx)[0][:max_object]
            keep = np.concatenate([h_sel, o_sel])
            boxes, labels, scores = boxes[keep], labels[keep], scores[keep]

        gt_boxes = np.asarray(
            list(target["boxes_h"]) + list(target["boxes_o"]), np.float64
        ).reshape(-1, 4)
        gt_classes = np.asarray(
            [human_idx] * len(target["boxes_h"]) + list(target["object"])
        )
        gt_boxes[:, :2] -= 1
        if len(gt_boxes):
            keep_gt = _np_batched_nms(gt_boxes, np.ones(len(gt_boxes)), gt_classes, nms_thresh)
            gt_boxes, gt_classes = gt_boxes[keep_gt], gt_classes[keep_gt]
        for c in gt_classes:
            num_gt[c] += 1

        binary = np.zeros_like(scores)
        for c in np.unique(labels):
            det_sel = np.nonzero(labels == c)[0]
            gt_sel = np.nonzero(gt_classes == c)[0]
            if len(gt_sel) == 0:
                continue
            binary[det_sel] = associate(gt_boxes[gt_sel], boxes[det_sel], scores[det_sel])
            max_recall_tp[c] += binary[det_sel].sum()
        meter.append(scores, labels, binary)

    meter.num_gt = num_gt.tolist()
    ap = meter.eval()
    with np.errstate(divide="ignore", invalid="ignore"):
        max_rec = np.where(num_gt > 0, max_recall_tp / np.maximum(num_gt, 1), 0.0)
    result = dict(
        map=float(ap.mean()),
        mean_max_recall=float(max_rec.mean()),
        ap=ap,
        num_gt=num_gt,
    )
    print(
        "Mean average precision: {:.4f} |".format(result["map"]),
        "Mean maximum recall: {:.4f}".format(result["mean_max_recall"]),
    )
    return result

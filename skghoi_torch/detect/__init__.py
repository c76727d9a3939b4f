"""Stage-1 detection: cache generation and detection-quality evaluation, and
the detectors: the torchvision-format Faster R-CNN (``frcnn``), the
trainable FPN detector (``detector``), AdaMixer (``adamixer``, with its
mmdet-layout converter ``adamixer_convert``) and DETR-R50 (``detr``)."""

from skghoi_torch.detect.generate import generate_gt_detections
from skghoi_torch.detect.eval_detections import compute_detection_map
from skghoi_torch.detect import adamixer, adamixer_convert, detector, detr, frcnn  # noqa: E402

__all__ = ["generate_gt_detections", "compute_detection_map", "adamixer", "adamixer_convert",
           "detector", "detr", "frcnn"]

"""Stage-1 detection: the torchvision-format Faster R-CNN, cache generation
and detection-quality evaluation."""

from skghoi_torch.detect.generate import generate_gt_detections
from skghoi_torch.detect.eval_detections import compute_detection_map

__all__ = ["generate_gt_detections", "compute_detection_map"]

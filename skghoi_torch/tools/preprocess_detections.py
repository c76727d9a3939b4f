"""Generate stage-1 detections with a Faster R-CNN, DETR or AdaMixer checkpoint.

    python -m skghoi_torch.tools.preprocess_detections \
        --data-root data/hicodet --partition train2015 --ckpt-path frcnn.pt \
        [--detector frcnn|detr|adamixer] [--cpu]

Mirrors ``skghoi_tpu.tools.preprocess_detections`` (the reference's
``hicodet/detections/preprocessing.py``): runs a ``fasterrcnn_resnet50_fpn``
checkpoint (a raw ``state_dict``, or a dict holding ``model_state_dict``,
read with ``torch.load(weights_only=True)``) over a dataset partition and
caches one JSON per image (boxes, labels, scores in original-image
coordinates; COCO ids remapped to HICO's 80 through ``coco80tohico80.json``
when the data root has it).  The detector is
:class:`skghoi_torch.detect.frcnn.FasterRCNN`, whose RoI pooling is the CUDA
RoIAlign kernel on the card.  It runs on ``cuda`` unless ``--cpu`` is given,
and raises without a card.

``--detector detr``: a facebookresearch/detr ``state_dict`` (detr-r50, 91
COCO classes) through :class:`skghoi_torch.detect.detr.DETR`: per-query
max-class scores, no NMS, boxes scaled by the padded canvas (the extent DETR
saw), COCO ids remapped as for Faster R-CNN.  ``--detector adamixer``: the
``.pt`` that ``train_detector --arch adamixer`` saves (``{"config",
"state_dict"}``: the decoder's geometry travels with the weights) or a bare
port ``state_dict`` (80 classes, the module defaults), through
:class:`skghoi_torch.detect.adamixer.AdaMixerDetector`: the last stage's
per-query argmax class and sigmoid score, HICO ids as they are.

Each image is resized on the host (``data.transforms``, as the JAX tool
does), pasted top-left into the canvas of its orientation and run alone.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from skghoi_torch import constants as C
from skghoi_torch.data.hicodet import HICODet
from skghoi_torch.data.transforms import bilinear_resize, canvas_for, resize_scale, resized_size
from skghoi_torch.detect.frcnn import FasterRCNN, load_torch_fasterrcnn
from skghoi_torch.detect.generate import generate_model_detections
from skghoi_torch.device import resolve_device


def detector_input(arr: np.ndarray, min_size: int = C.IMAGE_MIN_SIZE,
                   max_size: int = C.IMAGE_MAX_SIZE, canvas=None, normalise: bool = True):
    """``arr`` (``[H, W, 3]`` in [0, 1]) resized by torchvision's rule,
    normalised (unless ``normalise`` is false) and pasted top-left into the
    canvas of its orientation (zeros elsewhere).  Returns (``[Hc, Wc, 3]``
    float32, (h, w) inside it, scale)."""
    h, w = arr.shape[:2]
    scale = resize_scale(h, w, min_size, max_size)
    nh, nw = resized_size(h, w, scale)
    cv = canvas if canvas is not None else canvas_for(nh, nw)
    nh, nw = min(nh, cv[0]), min(nw, cv[1])
    resized = bilinear_resize(arr.astype(np.float32), nh, nw)
    padded = np.zeros((cv[0], cv[1], 3), np.float32)
    if normalise:
        resized = (resized - np.asarray(C.IMAGE_MEAN, np.float32)) / np.asarray(
            C.IMAGE_STD, np.float32)
    padded[:nh, :nw] = resized
    return padded, (nh, nw), scale


def build_detector_fn(state_dict, score_thresh: float, nms_thresh: float, num_detections: int,
                      min_size: int = C.IMAGE_MIN_SIZE, max_size: int = C.IMAGE_MAX_SIZE,
                      canvas=None, device=None):
    """Returns ``detector(arr [H, W, 3] in [0, 1]) -> (boxes, labels, scores)``
    in original-image coordinates with COCO class ids.  ``state_dict`` is the
    port model's (:func:`load_torch_fasterrcnn` of a torchvision one).
    ``min_size``/``max_size``/``canvas`` override the torchvision transform
    envelope (tests use small values)."""
    device = resolve_device(device)
    model = FasterRCNN(box_score_thresh=score_thresh, box_nms_thresh=nms_thresh,
                       detections_per_img=num_detections, device=device)
    model.load_state_dict(state_dict, strict=True)
    model.eval()

    def detector(arr: np.ndarray):
        padded, (nh, nw), scale = detector_input(arr, min_size, max_size, canvas)
        det = model(torch.from_numpy(padded)[None].to(device),
                    torch.tensor([[float(nh), float(nw)]], device=device))
        valid = det.valid[0].cpu().numpy()
        boxes = det.boxes[0].cpu().numpy()[valid] / scale
        return boxes, det.labels[0].cpu().numpy()[valid], det.scores[0].cpu().numpy()[valid]

    return detector


def build_detr_detector_fn(state_dict, score_thresh: float, num_classes: int = 91,
                           min_size: int = C.IMAGE_MIN_SIZE, max_size: int = C.IMAGE_MAX_SIZE,
                           canvas=None, device=None):
    """DETR flavour of :func:`build_detector_fn` (``main_detr.py`` path):
    ``state_dict`` is the port model's (:func:`~skghoi_torch.detect.detr.load_torch_detr`
    of a facebookresearch one); per-query max-class scores, no NMS."""
    from skghoi_torch.detect.detr import DETR

    device = resolve_device(device)
    model = DETR(num_classes=num_classes, device=device)
    model.load_state_dict(state_dict, strict=True)
    model.eval()

    def detector(arr: np.ndarray):
        padded, _, scale = detector_input(arr, min_size, max_size, canvas)
        # DETR normalises boxes to the padded canvas it saw: scale by the
        # canvas, then back to original-image coordinates.
        det = model(torch.from_numpy(padded)[None].to(device),
                    torch.tensor([[float(padded.shape[0]), float(padded.shape[1])]], device=device))
        keep = (det.scores[0] >= score_thresh).cpu().numpy()
        return (det.boxes[0].cpu().numpy()[keep] / scale, det.labels[0].cpu().numpy()[keep],
                det.scores[0].cpu().numpy()[keep])

    return detector


def build_adamixer_detector_fn(state_dict, score_thresh: float, num_classes: int = 80,
                               min_size: int = C.IMAGE_MIN_SIZE,
                               max_size: int = C.IMAGE_MAX_SIZE, canvas=None, device=None,
                               **model_overrides):
    """AdaMixer flavour (the reference's stage-1 generation pipeline,
    ``hicodet/detections/adamixer_preprocessing.py:43-58``): the last stage's
    per-query (argmax class, sigmoid of the largest logit); a query detector
    emits a fixed set, so no NMS.  The model normalises its input itself."""
    from skghoi_torch.detect.adamixer import AdaMixerDetector

    device = resolve_device(device)
    model = AdaMixerDetector(num_classes=num_classes, device=device, **model_overrides)
    model.load_state_dict(state_dict, strict=True)
    model.eval()

    @torch.no_grad()
    def detector(arr: np.ndarray):
        padded, _, scale = detector_input(arr, min_size, max_size, canvas, normalise=False)
        out = model(torch.from_numpy(padded)[None].to(device))
        logits = out.cls_logits[-1, 0].cpu().numpy()  # the last stage
        boxes = out.boxes[-1, 0].cpu().numpy() / scale
        scores = 1.0 / (1.0 + np.exp(-logits.max(axis=1)))
        keep = scores >= score_thresh
        return boxes[keep], logits.argmax(axis=1)[keep], scores[keep]

    return detector


def load_adamixer_checkpoint(path: str):
    """``(state_dict, num_classes, geometry overrides)`` of an AdaMixer
    ``.pt``: ``{"config", "state_dict"}`` as ``train_detector`` saves it, or
    a bare ``state_dict`` (80 classes, the module defaults)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "config" in blob:
        cfg = {k: int(v) for k, v in blob["config"].items()}
        return blob["state_dict"], cfg.pop("num_classes"), cfg
    return blob, 80, {}


def load_checkpoint_state_dict(path: str):
    """A checkpoint's ``state_dict``: the file itself, or its
    ``model_state_dict`` entry."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    return blob


def build_argparser():
    parser = argparse.ArgumentParser(description="Faster R-CNN detection generation")
    parser.add_argument("--partition", type=str, default="train2015")
    parser.add_argument("--data-root", type=str, default="data/hicodet")
    parser.add_argument("--cache-dir", type=str, default="detections")
    parser.add_argument("--ckpt-path", type=str, required=True)
    parser.add_argument("--score-thresh", type=float, default=0.05)
    parser.add_argument("--nms-thresh", type=float, default=0.5)
    parser.add_argument("--num-detections-per-image", type=int, default=100)
    parser.add_argument("--detector", choices=["frcnn", "detr", "adamixer"], default="frcnn",
                        help="checkpoint format: torchvision Faster R-CNN, facebookresearch/detr "
                             "DETR-R50, or the .pt of train_detector --arch adamixer")
    parser.add_argument("--min-size", type=int, default=C.IMAGE_MIN_SIZE,
                        help="resize envelope (tests use small values)")
    parser.add_argument("--max-size", type=int, default=C.IMAGE_MAX_SIZE)
    parser.add_argument("--canvas", type=int, nargs=2, default=None,
                        help="fixed H W canvas override (must be /32)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return parser


def main(argv=None):
    """Returns the cache directory it wrote."""
    args = build_argparser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    canvas = tuple(args.canvas) if args.canvas else None

    dataset = HICODet(
        root=os.path.join(args.data_root, f"hico_20160224_det/images/{args.partition}"),
        anno_file=os.path.join(args.data_root, f"instances_{args.partition}.json"),
    )
    coco2hico = None
    mapping_path = os.path.join(args.data_root, "coco80tohico80.json")
    if os.path.exists(mapping_path):
        with open(mapping_path) as f:
            coco2hico = json.load(f)

    envelope = dict(min_size=args.min_size, max_size=args.max_size, canvas=canvas, device=device)
    if args.detector == "adamixer":
        state, num_classes, overrides = load_adamixer_checkpoint(args.ckpt_path)
        detector = build_adamixer_detector_fn(state, args.score_thresh, num_classes=num_classes,
                                              **envelope, **overrides)
        coco2hico = None  # trained on HICO ids directly
    elif args.detector == "detr":
        from skghoi_torch.detect.detr import load_torch_detr

        detector = build_detr_detector_fn(
            load_torch_detr(load_checkpoint_state_dict(args.ckpt_path)), args.score_thresh,
            **envelope)
    else:
        detector = build_detector_fn(
            load_torch_fasterrcnn(load_checkpoint_state_dict(args.ckpt_path)), args.score_thresh,
            args.nms_thresh, args.num_detections_per_image, **envelope)
    cache_dir = os.path.join(args.cache_dir, args.partition)
    generate_model_detections(detector, dataset, cache_dir, score_thresh=args.score_thresh,
                              label_map=coco2hico)
    print(f"Cached {len(dataset)} detection files under {cache_dir}")
    return cache_dir


if __name__ == "__main__":
    main()

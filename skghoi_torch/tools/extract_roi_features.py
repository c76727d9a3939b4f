"""Pre-extract pooled RoI features for cached detections.

    python -m skghoi_torch.tools.extract_roi_features --data-root hicodet \
        --detection-dir hicodet/detections/train2015 --output-dir roi_features [--cpu]

Mirrors ``skghoi_tpu.tools.extract_roi_features`` (a working version of the
reference's ``detections_convert.py``): run the backbone once per batch,
filter the cached detections, RoIAlign their boxes, and store
``[N, 7, 7, 256]`` features and metadata per image as ``.npz``, so stage-2
head experiments can skip the backbone.  The pooling is
:func:`skghoi_torch.ops.roi_align_cuda.roi_align_auto`: the CUDA kernel
(one launch a batch) on the card, its plain version on the CPU.  It runs on
``cuda`` unless ``--cpu`` is given, and raises without a card.

As in the JAX tool, the backbone's weights are seeded random ones (seed 0):
the tool takes no weights.  :func:`extract_features` takes any backbone.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description="Pre-extract RoI features")
    p.add_argument("--data-root", default="hicodet")
    p.add_argument("--detection-dir", default="hicodet/detections/train2015")
    p.add_argument("--partition", default="train2015")
    p.add_argument("--output-dir", default="roi_features")
    p.add_argument("--batch-size", default=4, type=int)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--max-batches", default=None, type=int)
    return p


def seeded_backbone(device):
    """The tool's backbone: ResNet-50 + FPN, float32, seeded random weights
    (seed 0), in eval mode on ``device``."""
    from skghoi_torch.models.backbone import DetectorBackbone
    from skghoi_torch.weights import init_parameters

    return init_parameters(DetectorBackbone(device="cpu"), seed=0).to(device).eval()


def extract_features(backbone, loader, output_dir: str, max_batches=None) -> int:
    """Backbone, detection filter and RoIAlign over ``loader``'s batches on
    the backbone's device; one ``.npz`` per image.  Returns the image count."""
    import torch

    from skghoi_torch.data.factory import to_device
    from skghoi_torch.models.interaction_head import filter_detections
    from skghoi_torch.ops.roi_align_cuda import roi_align_auto

    device = next(backbone.parameters()).device
    dataset = loader.factory.dataset
    os.makedirs(output_dir, exist_ok=True)
    count = 0
    for b_num, (batch, indices) in enumerate(loader):
        if max_batches is not None and b_num >= max_batches:
            break
        b = to_device(batch, device)
        with torch.no_grad():
            feats = backbone(b.images)
            dets = filter_detections(b.det_boxes, b.det_labels, b.det_scores, b.det_valid)
            pooled = roi_align_auto(feats, dets.boxes).cpu().numpy()
        boxes, labels, scores = (t.cpu().numpy() for t in (dets.boxes, dets.labels, dets.scores))
        n_all, n_h_all = dets.n.cpu().numpy(), dets.n_h.cpu().numpy()
        for slot, ds_index in enumerate(indices):
            n = int(n_all[slot])
            np.savez_compressed(
                os.path.join(output_dir, dataset.filename(ds_index).replace(".jpg", ".npz")),
                features=pooled[slot, :n],
                boxes=boxes[slot, :n],
                labels=labels[slot, :n],
                scores=scores[slot, :n],
                n_h=int(n_h_all[slot]),
            )
            count += 1
    return count


def main(argv=None):
    """Returns the number of images written."""
    args = build_argparser().parse_args(argv)

    from skghoi_torch.data.factory import DataFactory, HOILoader
    from skghoi_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    factory_kwargs = {}
    if args.synthetic:
        import tempfile

        from skghoi_torch.data.synthetic import make_synthetic_hicodet

        root = tempfile.mkdtemp(prefix="skghoi_roi_")
        make_synthetic_hicodet(root, args.partition, num_images=4)
        args.data_root = root
        args.detection_dir = os.path.join(root, f"detections_{args.partition}")
        factory_kwargs = dict(
            min_size=64, max_size=107, canvas_landscape=(64, 96), canvas_portrait=(96, 64)
        )

    factory = DataFactory(
        "hicodet", args.partition, args.data_root, args.detection_dir, **factory_kwargs
    )
    loader = HOILoader(factory, args.batch_size, shuffle=False, with_targets=False)
    count = extract_features(seeded_backbone(device), loader, args.output_dir, args.max_batches)
    print(f"Extracted RoI features for {count} images into {args.output_dir}")
    return count


if __name__ == "__main__":
    main()

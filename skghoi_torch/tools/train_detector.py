"""Train the stage-1 detector on HICO-DET boxes, on a CUDA card.

    python -m skghoi_torch.tools.train_detector [--cpu] [--synthetic] [--arch fpn|adamixer] ...

Mirrors ``skghoi_tpu.tools.train_detector`` (the counterpart of the
reference's DETR fine-tuning entry, ``hicodet/detections/main_detr.py``),
with the same flags and defaults.  The ground truth of an image is its HOI
pairs' human boxes (label ``HICO_HUMAN_IDX``) and object boxes.

- ``--arch fpn``: the RetinaNet-style :class:`~skghoi_torch.detect.detector.FPNDetector`
  (anchors cached per canvas); one step is the forward, ``detector_loss``,
  the backward and AdamW.  Each epoch saves ``det_{epoch:02d}.pt``
  (``train.checkpoint.save_checkpoint``).
- ``--arch adamixer``: :class:`~skghoi_torch.detect.adamixer.AdaMixerDetector`;
  one step is the forward, the host Hungarian per (stage, image) on the
  deduplicated GT (:func:`_first_occurrence_mask`), ``set_loss``, the
  backward and AdamW.  Each epoch saves ``adamixer_{epoch:02d}.pt``:
  ``{"config": ..., "state_dict": ...}``, which ``preprocess_detections
  --detector adamixer`` reads (the JAX tool writes a flax msgpack instead).

The optimiser is plain AdamW over every trainable parameter (lr and weight
decay from the flags, betas (0.9, 0.999), eps 1e-8: optax's ``adamw``).
``--frozen-stages`` (AdaMixer only; default -1, every stage trained, as the
JAX tool) freezes the ResNet-50's stem and ``layer1..k`` as mmdet does: the
published AdaMixer recipe takes 1.  A frozen parameter gets no gradient, no
AdamW state and no weight decay.  The model starts from seeded random
weights (seed 0).  It runs on ``cuda`` unless ``--cpu`` is given, and raises
without a card.

One batch of the loader is one call of :func:`train_batch`: the batch to
the device, the ground truth, AdaMixer's de-duplication, and the step.

Under ``torchrun`` it trains data parallel, one process per card (NCCL;
gloo with ``--cpu``): each rank loads its shard and a batch of
``--batch-size`` images, the gradients are averaged by one flat all-reduce,
the losses' normalisers (positive anchors, GT boxes) are global, and only
rank 0 logs and saves.  ``--synthetic`` generates 8 images and trains at
64x96 for at most 2 epochs, printing every step.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from skghoi_torch import constants as C
from skghoi_torch.utils.profiling import span


def _first_occurrence_mask(boxes, labels, valid):
    """Mask keeping only the first occurrence of each (label, box) per image.

    ``boxes`` [B,N,4], ``labels`` [B,N], ``valid`` [B,N] -> bool [B,N].
    Coordinates are rounded to 0.1 px so float jitter can't split a
    duplicate: HICO-DET repeats a person's box across that person's HOI
    pairs, and a set loss needs each real box once."""
    rounded = np.round(np.asarray(boxes, np.float64), 1)
    labels = np.asarray(labels)
    valid = np.asarray(valid, bool)
    keep = np.zeros(valid.shape, bool)
    for i in range(valid.shape[0]):
        seen = set()
        for j in range(valid.shape[1]):
            if not valid[i, j]:
                continue
            key = (int(labels[i, j]), *rounded[i, j].tolist())
            if key not in seen:
                seen.add(key)
                keep[i, j] = True
    return keep


def build_argparser():
    p = argparse.ArgumentParser(description="Train the stage-1 detector")
    p.add_argument("--data-root", default="hicodet")
    p.add_argument("--partition", default="train2015")
    p.add_argument("--num-epochs", default=10, type=int)
    p.add_argument("--batch-size", default=4, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--weight-decay", default=1e-4, type=float)
    p.add_argument("--cache-dir", default="./detector_checkpoints")
    p.add_argument("--print-interval", default=100, type=int)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-root", default=None,
                   help="directory for the synthetic dataset (shared with "
                        "later pipeline stages; default: fresh tmpdir)")
    p.add_argument("--arch", choices=["fpn", "adamixer"], default="fpn")
    p.add_argument("--num-queries", default=100, type=int)
    p.add_argument("--num-stages", default=6, type=int)
    p.add_argument("--content-dim", default=256, type=int)
    p.add_argument("--groups", default=4, type=int)
    p.add_argument("--in-points", default=32, type=int)
    p.add_argument("--out-points", default=128, type=int)
    p.add_argument("--ffn-dim", default=2048, type=int)
    p.add_argument("--frozen-stages", default=-1, type=int,
                   help="AdaMixer: freeze the ResNet-50 stem and layer1..k (mmdet's "
                        "frozen_stages; the published recipe takes 1; -1 trains all)")
    return p


def ground_truth(targets):
    """The detector's GT from a batch's HOI targets: ``boxes_h ++ boxes_o``,
    human label then object labels, the pairs' validity twice."""
    boxes = torch.cat([targets.boxes_h, targets.boxes_o], dim=1)
    labels = torch.cat([torch.full_like(targets.object, C.HICO_HUMAN_IDX), targets.object], dim=1)
    valid = torch.cat([targets.valid, targets.valid], dim=1)
    return boxes, labels, valid


def adamw(model: torch.nn.Module, lr: float, weight_decay: float) -> torch.optim.AdamW:
    """optax ``adamw(lr, weight_decay=...)`` over every trainable parameter
    (a frozen one takes no state and no decay)."""
    return torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], lr=lr,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def _apply(model, optimizer, losses: dict):
    """Backward of the losses' sum, the gradients of the trainable parameters
    and the losses averaged over the ranks by one all-reduce, then the AdamW
    step.  A trainable parameter the losses do not reach takes a zero
    gradient; a frozen one is left alone."""
    from skghoi_torch.parallel.mesh import all_reduce_mean_

    with span("backward"):
        sum(losses.values()).backward()
    with span("optimizer"):
        params = [p for p in model.parameters() if p.requires_grad]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        for p, g in zip(params, grads):
            p.grad = g
        out = {k: v.detach() for k, v in losses.items()}
        all_reduce_mean_([*grads, *out.values()])
        optimizer.step()
    return out


def build_fpn_step(model, optimizer):
    """``step(images, gt_boxes, gt_labels, gt_valid) -> {"cls_loss",
    "box_loss"}`` (the ranks' averages, on the device): one FPN training
    step, anchors cached per canvas on the model's device."""
    from skghoi_torch.detect.detector import detector_loss, generate_anchors

    anchors = {}

    def step(images, gt_boxes, gt_labels, gt_valid):
        canvas = tuple(images.shape[1:3])
        if canvas not in anchors:
            anchors[canvas] = torch.from_numpy(generate_anchors(canvas)).to(images.device)
        optimizer.zero_grad(set_to_none=False)
        with span("forward"):
            logits, deltas = model(images)
        return _apply(model, optimizer, detector_loss(logits, deltas, anchors[canvas], gt_boxes,
                                                      gt_labels, gt_valid))

    step.model, step.optimizer = model, optimizer
    return step


def build_adamixer_step(model, optimizer):
    """``step(images, gt_boxes, gt_labels, gt_valid) -> {"set_loss"}`` (the
    ranks' average, on the device): the forward, the host Hungarian per
    (stage, image) on the outputs, ``set_loss``, the backward and AdamW.
    ``gt_valid`` is taken as given (deduplicate first)."""
    from skghoi_torch.detect import adamixer

    def step(images, gt_boxes, gt_labels, gt_valid):
        optimizer.zero_grad(set_to_none=False)
        with span("forward"):
            out = model(images)
        hw = (float(images.shape[1]), float(images.shape[2]))
        assignments = adamixer.compute_assignments(out, gt_boxes, gt_labels, gt_valid, hw)
        with span("set_loss"):
            losses = adamixer.set_loss(out, torch.from_numpy(assignments), gt_boxes, gt_labels,
                                       gt_valid, hw)
        return _apply(model, optimizer, losses)

    step.model, step.optimizer = model, optimizer
    return step


def train_batch(step, batch, device, arch: str) -> dict:
    """One training step on one collated loader batch (numpy ``HOIBatch``
    with targets): ``to_device``, the detector's ground truth, for
    ``arch == "adamixer"`` its de-duplication on the host, then ``step``
    (:func:`build_fpn_step` or :func:`build_adamixer_step`).  Returns the
    step's losses, on the device."""
    from skghoi_torch.data.factory import to_device

    hoi = to_device(batch, device)
    with span("ground_truth"):
        gt_boxes, gt_labels, gt_valid = ground_truth(hoi.targets)
        if arch == "adamixer":
            gt_valid = torch.from_numpy(_first_occurrence_mask(
                gt_boxes.cpu().numpy(), gt_labels.cpu().numpy(),
                gt_valid.cpu().numpy())).to(device)
    return step(hoi.images, gt_boxes, gt_labels, gt_valid)


def main(argv=None):
    """Returns ``{"model", "losses" (one dict a step), "checkpoints"}``."""
    args = build_argparser().parse_args(argv)

    from skghoi_torch.data.factory import DataFactory, HOILoader
    from skghoi_torch.device import resolve_device
    from skghoi_torch.parallel import distributed
    from skghoi_torch.parallel.mesh import all_gather_object, all_reduce_max, replicate

    device = resolve_device(distributed.device_for(args.cpu))
    own_group = distributed.initialize(device)
    world, rank = distributed.world_size(), distributed.rank()

    factory_kwargs = {}
    if args.synthetic:
        import tempfile

        from skghoi_torch.data.synthetic import make_synthetic_hicodet

        root = args.synthetic_root or (
            tempfile.mkdtemp(prefix="skghoi_det_") if distributed.is_main() else None)
        root = all_gather_object(root)[0]
        if distributed.is_main():
            make_synthetic_hicodet(root, args.partition, num_images=8)
        distributed.barrier()
        args.data_root = root
        det_dir = os.path.join(root, f"detections_{args.partition}")
        factory_kwargs = dict(min_size=64, max_size=107, canvas_landscape=(64, 96),
                              canvas_portrait=(96, 64))
        args.num_epochs = min(args.num_epochs, 2)
        args.print_interval = 1
    else:
        det_dir = os.path.join(args.data_root, "detections", args.partition)

    factory = DataFactory("hicodet", args.partition, args.data_root, det_dir, flip=True,
                          **factory_kwargs)
    loader = HOILoader(factory, args.batch_size, shuffle=True, with_targets=True,
                       num_shards=world, shard_index=rank)

    if args.arch == "adamixer":
        from skghoi_torch.detect.adamixer import AdaMixerDetector

        cfg = dict(num_classes=C.HICO_NUM_OBJECTS, num_queries=args.num_queries,
                   num_stages=args.num_stages, content_dim=args.content_dim, groups=args.groups,
                   in_points=args.in_points, out_points=args.out_points, ffn_dim=args.ffn_dim)
        model = replicate(AdaMixerDetector(**cfg, device=device, frozen_stages=args.frozen_stages))
        step = build_adamixer_step(model, adamw(model, args.lr, args.weight_decay))
    else:
        from skghoi_torch.detect.detector import FPNDetector

        model = replicate(FPNDetector(device=device))
        step = build_fpn_step(model, adamw(model, args.lr, args.weight_decay))

    history, checkpoints, it = [], [], 0
    for epoch in range(args.num_epochs):
        loader.set_epoch(epoch)
        # Every rank takes as many steps as the rank with the most batches,
        # taking its last batch again when its own run out.
        steps, batch = all_reduce_max(len(loader)), None
        batches = iter(loader)
        for _ in range(steps):
            batch = next(batches, (batch, None))[0]
            losses = train_batch(step, batch, device, args.arch)
            it += 1
            if it % args.print_interval == 0:
                losses = {k: v.item() for k, v in losses.items()}
                history.append(losses)
                if distributed.is_main():
                    print(f"iter {it}: " + (f"set_loss {losses['set_loss']:.4f}"
                                            if args.arch == "adamixer" else
                                            f"cls {losses['cls_loss']:.4f} "
                                            f"box {losses['box_loss']:.4f}"), flush=True)
        if distributed.is_main():
            os.makedirs(args.cache_dir, exist_ok=True)
            if args.arch == "adamixer":
                path = os.path.join(args.cache_dir, f"adamixer_{epoch:02d}.pt")
                state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
                torch.save({"config": cfg, "state_dict": state}, path)
                print(f"Saved {path}")
            else:
                from skghoi_torch.train.checkpoint import save_checkpoint

                path = os.path.join(args.cache_dir, f"det_{epoch:02d}.pt")
                save_checkpoint(path, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                                step.optimizer.state_dict(), epoch, it)
            checkpoints.append(path)
        distributed.barrier()
    if distributed.is_main():
        print("Detector training complete.")
    if own_group:
        distributed.shutdown()
    return dict(model=model, losses=history, checkpoints=checkpoints)


if __name__ == "__main__":
    main()

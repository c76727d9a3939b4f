"""End-to-end input-pipeline benchmark: on-disk JPEGs -> device batches.

    python -m skghoi_torch.tools.bench_io [--num-images 64] [--batch-size 8]
        [--num-workers 4] [--epochs 3] [--train] [--cpu] [--small]

Mirrors ``skghoi_tpu.tools.bench_io`` (the reference engine's input path,
``utils.py:200-229``: DataLoader decode/resize/collate feeding the train
loop), on ``cuda`` unless ``--cpu`` is given (without a card it raises):

  1. loader: JPEG decode -> resize -> canvas pad -> collate -> the pinned
     host-to-device copy of :func:`skghoi_torch.data.factory.to_device`,
     through :class:`HOILoader`'s threaded prefetch, at the real 832x1344
     geometry; with ``--device-resize`` the raw uint8 batch is resized into
     its canvas on the device (:mod:`skghoi_torch.data.device_preprocess`).
  2. ``--train``: the same loader feeding the float32 SCG train step
     (forward, 3 losses, backward, AdamW) of
     :class:`~skghoi_torch.train.engine.LearningEngine`, i.e. images/s
     including the input, with one RoIAlign kernel launch and one adjoint a
     step on the card.

Each timed span ends with ``torch.cuda.synchronize()`` on the card (JAX's
``block_until_ready``).  Synthetic on-disk images are generated at HICO-like
resolutions so the decode/resize cost is realistic, into ``--root`` or a
temporary directory that is removed at the end.  Prints one JSON line per
section; ``"platform"`` is the device type.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def build_argparser():
    p = argparse.ArgumentParser(description="input-pipeline-included benchmark")
    p.add_argument("--num-images", default=64, type=int)
    p.add_argument("--batch-size", default=8, type=int, help="global batch")
    p.add_argument("--num-workers", default=4, type=int)
    p.add_argument("--prefetch", default=2, type=int)
    p.add_argument("--epochs", default=3, type=int,
                   help="epoch 1 warms caches/compile; report the rest")
    p.add_argument("--image-size", default=[480, 640], nargs=2, type=int,
                   help="on-disk H W (HICO-like)")
    p.add_argument("--train", action="store_true",
                   help="also run the loader-overlapped SCG train step")
    p.add_argument("--device-resize", action="store_true",
                   help="raw-uint8 loader + on-device bilinear resize/canvas "
                        "(data/device_preprocess) instead of host resize")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--small", action="store_true",
                   help="tiny transform geometry (CI smoke, not a benchmark)")
    p.add_argument("--root", default=None, help="reuse an existing dataset dir")
    return p


def main(argv=None):
    """Returns the printed sections, ``{"loader": ..., "train_e2e": ...}``."""
    args = build_argparser().parse_args(argv)

    from skghoi_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if args.root:
        return _run(args, args.root, device)
    with tempfile.TemporaryDirectory(prefix="skghoi_io_") as root:
        return _run(args, root, device)


def _run(args, root: str, device) -> dict:
    import numpy as np

    from skghoi_torch.data.device_preprocess import prepare_batch
    from skghoi_torch.data.factory import DataFactory, HOILoader, to_device
    from skghoi_torch.data.synthetic import make_synthetic_hicodet
    from skghoi_torch.device import synchronize

    part = "train2015"
    if not os.path.isdir(os.path.join(root, "hico_20160224_det")):
        make_synthetic_hicodet(root, part, num_images=args.num_images,
                               image_size=tuple(args.image_size))
    factory_kwargs = {}
    if args.small:
        factory_kwargs = dict(min_size=64, max_size=107,
                              canvas_landscape=(64, 96), canvas_portrait=(96, 64))
    if args.device_resize:
        factory_kwargs["device_resize"] = True
        if args.small:
            factory_kwargs["raw_canvas_landscape"] = (480, 640)
            factory_kwargs["raw_canvas_portrait"] = (640, 480)
    factory = DataFactory(
        "hicodet", part, root, os.path.join(root, f"detections_{part}"),
        flip=True, **factory_kwargs,
    )
    loader = HOILoader(factory, args.batch_size, shuffle=True,
                       with_targets=True, num_workers=args.num_workers,
                       prefetch=args.prefetch)

    n_img = len(factory)
    epoch_rates = []
    for ep in range(args.epochs):
        loader.set_epoch(ep)
        t0 = time.time()
        # Short batches are padded by repeating an already-decoded sample;
        # count unique dataset indices so padding can't inflate img/s.
        seen_idx = set()
        for batch, indices in loader:
            # the host->device copy the train step pays, and with
            # --device-resize the resize into the canvas on the device
            prepare_batch(to_device(batch, device), factory)
            synchronize(device)
            seen_idx.update(int(i) for i in indices)
        dt = time.time() - t0
        epoch_rates.append(len(seen_idx) / dt)
    steady = epoch_rates[1:] or epoch_rates
    sections = {"loader": {
        "section": "loader", "platform": device.type,
        "num_images": n_img, "batch": args.batch_size,
        "num_workers": args.num_workers, "image_size": list(args.image_size),
        "small": args.small, "device_resize": args.device_resize,
        "epoch_imgs_per_s": [round(r, 2) for r in epoch_rates],
        "imgs_per_s": round(float(np.median(steady)), 2),
    }}
    print(json.dumps(sections["loader"]), flush=True)

    if not args.train:
        return sections

    import torch

    from skghoi_torch.entry import build_model
    from skghoi_torch.train.engine import LearningEngine

    model = build_model(dtype=torch.float32, device=device, seed=0)
    engine = LearningEngine(
        model, loader,
        object_verb_mask=factory.dataset.object_verb_mask(),
        print_interval=10_000, cache_dir=os.path.join(root, "ckpt_bench"),
    )
    train_rates = []
    epoch_walls = []
    for ep in range(args.epochs):
        t0 = time.time()
        engine.run(1)
        synchronize(device)
        epoch_walls.append(time.time() - t0)
        train_rates.append(n_img / epoch_walls[-1])
    steady = train_rates[1:] or train_rates
    steady_wall = float(np.median(epoch_walls[1:] or epoch_walls))
    sections["train_e2e"] = {
        "section": "train_e2e", "platform": device.type,
        "num_images": n_img, "batch": args.batch_size,
        "num_workers": args.num_workers, "small": args.small,
        "epoch_imgs_per_s": [round(r, 2) for r in train_rates],
        "imgs_per_s": round(float(np.median(steady)), 2),
        # The first epoch pays cuDNN's algorithm search, the allocator's
        # growth and AdamW's lazy state (JAX's: the train step's compile);
        # its excess over a steady epoch is the time to the first steps.
        "first_epoch_seconds": round(epoch_walls[0], 1),
        "first_epoch_overhead_seconds": round(epoch_walls[0] - steady_wall, 1),
    }
    print(json.dumps(sections["train_e2e"]), flush=True)
    return sections


if __name__ == "__main__":
    main()

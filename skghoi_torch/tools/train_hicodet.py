"""Train the SCG HOI network on HICO-DET (or V-COCO) on a CUDA card.

    python -m skghoi_torch.tools.train_hicodet [--cpu] [--synthetic] ...

Mirrors ``skghoi_tpu.tools.train_hicodet`` (the reference train entry,
``configures/hicodet/adamixer_transH_spatial_r50_main.py``): the same flags
and defaults (lr 1e-4, backbone lr-decay 0.1, wd 1e-4, milestone at epoch 6,
batch 4 per device, print interval 2000, cache dir ./checkpoints) and the
same log lines.  It runs on ``cuda`` unless ``--cpu`` is given, and raises
without a card.

Run plainly, one process drives one card.  Under ``torchrun`` it trains data
parallel, one process per card (NCCL; gloo with ``--cpu``)::

    python -m torch.distributed.run --nproc-per-node 4 \
        -m skghoi_torch.tools.train_hicodet --batch-size 4 ...

Each rank loads its shard of the data and a batch of ``--batch-size``
images, so the global batch is ``--batch-size`` x the number of processes;
the engine averages the gradients and only rank 0 logs and saves.
The model trains in float32 with ``frozen_stages=1`` (the model's defaults),
from seeded random weights (``weights.init_parameters``).

``--synthetic`` generates a tiny on-disk dataset and runs the whole pipeline
at 64x96 for one epoch.  ``--transh-init`` loads the TransH tables that
``tools.pretrain_transh_hoi`` saved (a ``torch.save`` state dict) into the
graph head before training.
"""

from __future__ import annotations

import argparse
import os

from skghoi_torch import constants as C


def build_argparser():
    p = argparse.ArgumentParser(description="Train the SCG HOI network")
    p.add_argument("--dataset", default="hicodet", choices=["hicodet", "vcoco"])
    p.add_argument("--partitions", nargs="+", default=["train2015", "test2015"])
    p.add_argument("--data-root", default="hicodet")
    p.add_argument("--train-detection-dir", default="hicodet/detections/train2015")
    p.add_argument("--val-detection-dir", default="hicodet/detections/test2015")
    p.add_argument("--num-iter", default=2, type=int, help="message passing iterations")
    p.add_argument("--num-epochs", default=8, type=int)
    p.add_argument("--batch-size", default=4, type=int, help="per device")
    p.add_argument("--lr-head", default=1e-4, type=float)
    p.add_argument("--lr-decay", default=0.1, type=float, help="backbone lr multiplier")
    p.add_argument("--weight-decay", default=1e-4, type=float)
    p.add_argument("--milestones", nargs="+", default=[6], type=int)
    p.add_argument("--lr-gamma", default=0.1, type=float)
    p.add_argument("--box-score-thresh", default=0.2, type=float)
    p.add_argument("--print-interval", default=2000, type=int)
    p.add_argument("--checkpoint-path", default="", help="resume from this checkpoint")
    p.add_argument(
        "--transh-init", default="",
        help="TransH checkpoint (pretrain_transh_hoi) to initialize KG embeddings",
    )
    p.add_argument("--cache-dir", default="./checkpoints")
    p.add_argument("--random-seed", default=1, type=int)
    p.add_argument("--feedback", action="store_true", help="true iterative message passing")
    p.add_argument(
        "--losses",
        nargs="+",
        default=None,
        choices=["hoi_loss", "interactiveness_loss", "transh_loss"],
        help="loss subset driving gradients (engine-variant parity; default all)",
    )
    p.add_argument("--replicate-reference-quirks", action="store_true")
    p.add_argument("--num-workers", default=4, type=int,
                   help="threaded sample-load workers (reference main.py:167)")
    p.add_argument("--synthetic", action="store_true", help="tiny generated dataset smoke run")
    p.add_argument("--synthetic-root", default=None,
                   help="reuse/create the synthetic dataset here (lets the "
                        "chained CLI tools share one dataset)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--device-resize", action="store_true",
                   help="ship raw uint8 to the device and resize/canvas there "
                        "(data/device_preprocess) instead of host numpy resize")
    return p


def main(argv=None):
    """Returns the :class:`~skghoi_torch.train.engine.LearningEngine` after
    its last epoch."""
    parser = build_argparser()
    args = parser.parse_args(argv)

    import torch

    from skghoi_torch.data.factory import DataFactory, HOILoader
    from skghoi_torch.device import resolve_device
    from skghoi_torch.entry import build_model
    from skghoi_torch.parallel import distributed
    from skghoi_torch.parallel.mesh import all_gather_object, replicate
    from skghoi_torch.train.engine import LearningEngine

    device = resolve_device(distributed.device_for(args.cpu))
    own_group = distributed.initialize(device)
    world, rank = distributed.world_size(), distributed.rank()
    if args.transh_init:  # read before anything is written
        from skghoi_torch.tools.pretrain_transh_hoi import load_pretrained_transh
        from skghoi_torch.train.checkpoint import load_checkpoint

        transh_state = load_checkpoint(args.transh_init)

    if args.synthetic:
        import tempfile

        from skghoi_torch.data.synthetic import make_synthetic_hicodet, make_synthetic_vcoco

        # Rank 0 writes the dataset; every rank reads it from rank 0's root.
        root = args.synthetic_root or (
            tempfile.mkdtemp(prefix="skghoi_synth_") if distributed.is_main() else None)
        root = all_gather_object(root)[0]
        part = "train2015" if args.dataset == "hicodet" else "train"
        if distributed.is_main():
            make = make_synthetic_hicodet if args.dataset == "hicodet" else make_synthetic_vcoco
            make(root, part, num_images=8)
        distributed.barrier()
        args.partitions = [part]
        args.data_root = root
        # Respect an explicit detection cache; default to the GT-derived
        # detections the synthetic builder ships.
        if args.train_detection_dir == "hicodet/detections/train2015":
            args.train_detection_dir = os.path.join(root, f"detections_{part}")
        args.val_detection_dir = args.train_detection_dir
        factory_kwargs = dict(
            min_size=64, max_size=107, canvas_landscape=(64, 96), canvas_portrait=(96, 64)
        )
        args.num_epochs = min(args.num_epochs, 1)
        args.print_interval = 1
    else:
        factory_kwargs = {}

    batch = args.batch_size
    if distributed.is_main():
        print(f"Devices: {world} ({device.type}); global batch {batch * world}")

    if args.device_resize:
        factory_kwargs["device_resize"] = True
        if args.synthetic:  # synthetic images are 120x160
            factory_kwargs["raw_canvas_landscape"] = (128, 160)
            factory_kwargs["raw_canvas_portrait"] = (160, 128)
    train_factory = DataFactory(
        args.dataset, args.partitions[0], args.data_root, args.train_detection_dir,
        flip=True, seed=args.random_seed, **factory_kwargs,
    )
    train_loader = HOILoader(
        train_factory, batch, shuffle=True, with_targets=True, seed=args.random_seed,
        num_workers=args.num_workers, num_shards=world, shard_index=rank,
    )
    val_loader = None
    if not args.synthetic and len(args.partitions) > 1:
        val_factory = DataFactory(
            args.dataset, args.partitions[1], args.data_root, args.val_detection_dir,
            flip=False, **factory_kwargs,
        )
        val_loader = HOILoader(val_factory, batch, shuffle=False, with_targets=False,
                               num_workers=args.num_workers, num_shards=world, shard_index=rank)

    num_classes = C.HICO_NUM_VERBS if args.dataset == "hicodet" else C.VCOCO_NUM_ACTIONS
    model = build_model(
        dtype=torch.float32, device=device, seed=args.random_seed, num_classes=num_classes,
        human_idx=train_factory.human_idx,
        num_iterations=args.num_iter,
        box_score_thresh=args.box_score_thresh,
        feedback=args.feedback,
        quirk_box_index_tails=args.replicate_reference_quirks,
    )
    if args.transh_init:
        load_pretrained_transh(model, transh_state)
        print(f"Initialized TransH embeddings from {args.transh_init}")
    replicate(model)
    engine = LearningEngine(
        model,
        train_loader,
        val_loader,
        num_classes=num_classes,
        object_verb_mask=train_factory.dataset.object_verb_mask(),
        print_interval=args.print_interval,
        cache_dir=args.cache_dir,
        learning_rate=args.lr_head,
        lr_decay=args.lr_decay,
        weight_decay=args.weight_decay,
        milestones=tuple(args.milestones),
        seed=args.random_seed,
        loss_keys=tuple(args.losses) if args.losses else None,
    )
    if args.checkpoint_path:
        engine.resume(args.checkpoint_path)
    engine.run(args.num_epochs)
    if distributed.is_main():
        print("Training complete.")
    if own_group:
        distributed.shutdown()
    return engine


if __name__ == "__main__":
    main()

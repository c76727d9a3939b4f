"""Evaluate a trained SCG checkpoint on HICO-DET (full/rare/non-rare mAP).

    python -m skghoi_torch.tools.test_hicodet --model-path ckpt_08.pt [--cpu] ...

Mirrors ``skghoi_tpu.tools.test_hicodet`` (the reference
``test/adamixer_transH_spatital_r50_test.py``): the rare split is the
classes with fewer than 10 GT pairs (``:30-33``), inference runs batched over
the cached detections, and the three means are printed (``:66-70``).  Runs
on ``cuda`` unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse


def build_argparser():
    p = argparse.ArgumentParser(description="Evaluate SCG on HICO-DET")
    p.add_argument("--data-root", default="hicodet")
    p.add_argument("--detection-dir", default="hicodet/detections/test2015")
    p.add_argument("--partition", default="test2015")
    p.add_argument("--model-path", default="", help="checkpoint to load")
    p.add_argument("--batch-size", default=4, type=int)
    p.add_argument("--num-iter", default=2, type=int)
    p.add_argument("--box-score-thresh", default=0.2, type=float)
    p.add_argument("--max-batches", default=None, type=int)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-root", default=None,
                   help="reuse/create the synthetic dataset here (lets the "
                        "chained CLI tools share one dataset)")
    return p


def checkpoint_eval_step(device, object_verb_mask, model_path: str = "", **model_kwargs):
    """``eval_step(params, batch)`` over collated numpy batches: the float32
    SCG (``model_kwargs``) on ``device`` with the weights of the checkpoint
    at ``model_path``, or seeded random weights without one."""
    import torch

    from skghoi_torch.data.factory import to_device
    from skghoi_torch.entry import build_model
    from skghoi_torch.parallel.train_step import build_eval_step
    from skghoi_torch.train.checkpoint import load_checkpoint, load_model_state

    model = build_model(dtype=torch.float32, device=device, seed=0, **model_kwargs)
    if model_path:
        load_model_state(model, load_checkpoint(model_path)["model_state_dict"])
    step = build_eval_step(model, torch.as_tensor(object_verb_mask, device=device))
    return lambda params, batch: step(to_device(batch, device))


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import os

    from skghoi_torch.data.factory import DataFactory, HOILoader
    from skghoi_torch.device import resolve_device
    from skghoi_torch.eval.hoi_eval import evaluate_hicodet

    device = resolve_device("cpu" if args.cpu else None)
    factory_kwargs = {}
    if args.synthetic:
        import tempfile

        from skghoi_torch.data.synthetic import make_synthetic_hicodet

        root = args.synthetic_root or tempfile.mkdtemp(prefix="skghoi_eval_synth_")
        make_synthetic_hicodet(root, args.partition, num_images=8)
        args.data_root = root
        args.detection_dir = os.path.join(root, f"detections_{args.partition}")
        factory_kwargs = dict(
            min_size=64, max_size=107, canvas_landscape=(64, 96), canvas_portrait=(96, 64)
        )

    factory = DataFactory(
        "hicodet", args.partition, args.data_root, args.detection_dir, **factory_kwargs
    )
    loader = HOILoader(factory, args.batch_size, shuffle=False, with_targets=False)
    eval_step = checkpoint_eval_step(device, factory.dataset.object_verb_mask(), args.model_path,
                                num_iterations=args.num_iter,
                                box_score_thresh=args.box_score_thresh)
    if args.model_path:
        print(f"Loaded checkpoint {args.model_path}")
    else:
        print("WARNING: no --model-path given; evaluating a random-init model.")
    result = evaluate_hicodet(
        eval_step, None, loader, factory.dataset, max_batches=args.max_batches
    )
    print(
        f"The mAP is {result['full']:.4f}, rare: {result['rare']:.4f}, "
        f"none-rare: {result['non_rare']:.4f}"
    )
    return result


if __name__ == "__main__":
    main()

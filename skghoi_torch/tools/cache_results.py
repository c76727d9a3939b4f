"""Cache inference results in official-evaluator formats (.mat / vcoco pkl).

    python -m skghoi_torch.tools.cache_results --dataset hicodet --model-path ckpt_08.pt ...

Mirrors ``skghoi_tpu.tools.cache_results`` (the reference ``cache.py:145-211``
CLI, same flags): runs the SCG network over cached detections and writes
either the per-object-class ``detections_XX.mat`` files (HICO-DET MATLAB
evaluator) or ``vcoco_results.pkl`` (official V-COCO evaluator input).  Runs
on ``cuda`` unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os


def build_argparser():
    p = argparse.ArgumentParser(description="Cache SCG inference results")
    p.add_argument("--dataset", default="vcoco", choices=["hicodet", "vcoco"])
    p.add_argument("--data-root", default="vcoco")
    p.add_argument("--detection-dir", default="vcoco/detections/test2014_r50_pretained")
    p.add_argument("--cache-dir", default="vcoco_cache")
    p.add_argument("--partition", default="test")
    p.add_argument("--num-iter", default=2, type=int)
    p.add_argument("--box-score-thresh", default=0.2, type=float)
    p.add_argument("--max-human", default=15, type=int)
    p.add_argument("--max-object", default=15, type=int)
    p.add_argument("--batch-size", default=4, type=int)
    p.add_argument("--model-path", default="", type=str)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-root", default=None,
                   help="reuse/create the synthetic dataset here (lets the "
                        "chained CLI tools share one dataset)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from skghoi_torch import constants as C
    from skghoi_torch.data.factory import DataFactory, HOILoader
    from skghoi_torch.device import resolve_device
    from skghoi_torch.eval.cache import build_coco_to_hico, cache_hicodet_mat, cache_vcoco_pkl
    from skghoi_torch.tools.test_hicodet import checkpoint_eval_step

    device = resolve_device("cpu" if args.cpu else None)
    factory_kwargs = {}
    if args.synthetic:
        import tempfile

        from skghoi_torch.data.synthetic import make_synthetic_hicodet, make_synthetic_vcoco

        root = args.synthetic_root or tempfile.mkdtemp(prefix="skghoi_cache_synth_")
        if args.dataset == "hicodet":
            args.partition = "test2015"
            make_synthetic_hicodet(root, args.partition, num_images=6)
        else:
            args.partition = "test"
            make_synthetic_vcoco(root, args.partition, num_images=6)
        args.data_root = root
        args.detection_dir = os.path.join(root, f"detections_{args.partition}")
        factory_kwargs = dict(
            min_size=64, max_size=107, canvas_landscape=(64, 96), canvas_portrait=(96, 64)
        )

    factory = DataFactory(
        args.dataset, args.partition, args.data_root, args.detection_dir, **factory_kwargs
    )
    loader = HOILoader(factory, args.batch_size, shuffle=False, with_targets=False)

    model_path = args.model_path
    if model_path and os.path.exists(model_path):
        print("Loading model from", model_path)
    elif model_path:
        print(
            "\nWARNING: The given model path does not exist. "
            "Proceed to use a randomly initialised model.\n"
        )
        model_path = ""
    eval_step = checkpoint_eval_step(
        device, factory.dataset.object_verb_mask(), model_path,
        num_classes=C.HICO_NUM_VERBS if args.dataset == "hicodet" else C.VCOCO_NUM_ACTIONS,
        human_idx=factory.human_idx,
        num_iterations=args.num_iter,
        box_score_thresh=args.box_score_thresh,
        max_human=args.max_human,
        max_object=args.max_object,
    )

    if args.dataset == "hicodet":
        mapping_path = os.path.join(args.data_root, "coco80tohico80.json")
        if os.path.exists(mapping_path):
            with open(mapping_path) as f:
                coco2hico = json.load(f)
        else:
            coco2hico = build_coco_to_hico(factory.dataset.objects, factory.dataset.objects)
        cache_hicodet_mat(eval_step, None, loader, factory.dataset, coco2hico, args.cache_dir)
    else:
        cache_vcoco_pkl(eval_step, None, loader, factory.dataset, args.cache_dir)
    print("Cached results to", args.cache_dir)


if __name__ == "__main__":
    main()

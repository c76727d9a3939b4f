"""Official-style V-COCO evaluation over cached pkl results.

Counterpart of the reference ``vcoco_evaluation.py:1-10``:

    vcocoeval = VCOCOeval(vsrl_annot_file, coco_file, split_file)
    vcocoeval._do_eval(det_file, ovr_thresh=0.5)

Here GT comes from our annotation JSON and the evaluator is built in
(:mod:`skghoi_torch.eval.vcoco_eval`).  Mirrors
``skghoi_tpu.tools.vcoco_evaluation``; host numpy, so it needs no card.
Returns the evaluator's ``{"per_action", "mean"}`` dict.

    python -m skghoi_torch.tools.vcoco_evaluation --data-root vcoco \
        --det-file vcoco_cache/vcoco_results.pkl
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="V-COCO scenario-1/2 role AP")
    p.add_argument("--data-root", default="vcoco")
    p.add_argument("--partition", default="test")
    p.add_argument("--det-file", default="vcoco_cache/vcoco_results.pkl")
    p.add_argument("--ovr-thresh", default=0.5, type=float)
    args = p.parse_args(argv)

    import os

    from skghoi_torch.data.vcoco import VCOCO
    from skghoi_torch.eval.vcoco_eval import VCOCOeval

    image_dir = "mscoco2014/val2014" if args.partition == "test" else "mscoco2014/train2014"
    dataset = VCOCO(
        root=os.path.join(args.data_root, image_dir),
        anno_file=os.path.join(args.data_root, f"instances_vcoco_{args.partition}.json"),
    )
    return VCOCOeval(dataset)._do_eval(args.det_file, ovr_thresh=args.ovr_thresh)


if __name__ == "__main__":
    main()

"""Split the HICO-DET training set into train/val subsets (host only).

    python -m skghoi_torch.tools.hicodet_split --data-root hicodet --output split.json

Mirrors ``skghoi_tpu.tools.hicodet_split`` (the reference
``hicodet/hicodet_split.py``, which calls ``HICODet.split(0.5)`` and discards
the result): writes the subset index pools to JSON so loaders can reproduce
the split.  The same seed gives the same JSON bytes as the JAX tool.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Split HICO-DET into train/val pools")
    p.add_argument("--data-root", default="hicodet")
    p.add_argument("--partition", default="train2015")
    p.add_argument("--ratio", default=0.5, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--output", default="hicodet_split.json")
    args = p.parse_args(argv)

    from skghoi_torch.data.hicodet import HICODet

    dataset = HICODet(
        root=os.path.join(args.data_root, "hico_20160224_det/images", args.partition),
        anno_file=os.path.join(args.data_root, f"instances_{args.partition}.json"),
    )
    train, val = dataset.split(args.ratio, seed=args.seed)
    with open(args.output, "w") as f:
        json.dump(dict(train=train.pool, val=val.pool, ratio=args.ratio, seed=args.seed), f)
    print(f"Split {len(dataset)} images -> {len(train)} train / {len(val)} val; wrote {args.output}")


if __name__ == "__main__":
    main()

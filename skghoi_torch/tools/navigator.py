"""Interactive HICO-DET dataset navigator.

Counterpart of ``hicodet/utilities/navigator.py:29-146``: a small REPL for
browsing the dataset — list interaction classes, show per-class counts, dump
an image's annotations, and search classes by name.

    python -m skghoi_torch.tools.navigator --data-root hicodet

Mirrors ``skghoi_tpu.tools.navigator`` on the port's ``HICODet``; host only.
"""

from __future__ import annotations

import argparse


HELP = """commands:
  classes [filter]   list interaction classes (optionally filtered by substring)
  counts             per-interaction GT pair counts (sorted)
  image <idx>        show annotations of dataset index <idx>
  objects            list object classes
  verbs              list verb classes
  help               this message
  quit               exit
"""


def main(argv=None):
    p = argparse.ArgumentParser(description="HICO-DET dataset navigator")
    p.add_argument("--data-root", default="hicodet")
    p.add_argument("--partition", default="train2015")
    args = p.parse_args(argv)

    import os

    from skghoi_torch.data.hicodet import HICODet

    dataset = HICODet(
        root=os.path.join(args.data_root, "hico_20160224_det/images", args.partition),
        anno_file=os.path.join(args.data_root, f"instances_{args.partition}.json"),
    )
    inter = dataset.interactions
    counts = dataset.anno_interaction
    print(f"{len(dataset)} images, {len(inter)} interaction classes")
    print(HELP)

    while True:
        try:
            line = input("navigator> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            continue
        cmd, *rest = line.split(maxsplit=1)
        arg = rest[0] if rest else ""
        if cmd == "quit":
            break
        elif cmd == "help":
            print(HELP)
        elif cmd == "classes":
            for i, name in enumerate(inter):
                if arg.lower() in name.lower():
                    print(f"{i:4d} {name} ({counts[i]} pairs)")
        elif cmd == "counts":
            order = sorted(range(len(counts)), key=lambda i: -counts[i])
            for i in order[:50]:
                print(f"{counts[i]:6d} {inter[i]}")
        elif cmd == "objects":
            for i, n in enumerate(dataset.objects):
                print(f"{i:3d} {n}")
        elif cmd == "verbs":
            for i, n in enumerate(dataset.verbs):
                print(f"{i:3d} {n}")
        elif cmd == "image":
            idx = int(arg)
            t = dataset.raw_target(idx)
            print(dataset.filename(idx), dataset.image_size(idx))
            for bh, bo, hoi in zip(t["boxes_h"], t["boxes_o"], t["hoi"]):
                print(f"  {inter[hoi]}: h={bh} o={bo}")
        else:
            print("unknown command; try 'help'")


if __name__ == "__main__":
    main()

"""Classify KG relations as 1-1 / 1-n / n-1 / n-n and split the test set.

Counterpart of the reference benchmarks' ``n-n.py`` generator: computes the
average heads-per-tail and tails-per-head of each relation over
train+valid+test and writes ``1-1.txt``/``1-n.txt``/``n-1.txt``/``n-n.txt``
(test-triple line numbers per category, matching the benchmark convention)
plus a summary.

    python -m skghoi_torch.tools.kge_relation_stats --data DIR [--output-dir OUT]

Mirrors ``skghoi_tpu.tools.kge_relation_stats`` on the port's
:class:`~skghoi_torch.kge.data.KGData`; host only.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="Relation category statistics")
    p.add_argument("--data", required=True, help="OpenKE benchmark dir")
    p.add_argument("--output-dir", default=None, help="defaults next to --data files")
    p.add_argument("--threshold", default=1.5, type=float)
    args = p.parse_args(argv)

    from skghoi_torch.kge.data import KGData

    data = KGData.load(args.data)
    allt = np.concatenate([data.train, data.valid, data.test], axis=0)

    heads_per_tail = defaultdict(set)  # (r, t) -> heads
    tails_per_head = defaultdict(set)
    for h, t, r in allt:
        heads_per_tail[(r, t)].add(h)
        tails_per_head[(r, h)].add(t)

    lef = np.zeros(data.rel_tot)  # avg heads per (r, t)
    rig = np.zeros(data.rel_tot)  # avg tails per (r, h)
    for r in range(data.rel_tot):
        ht = [len(v) for (rr, _), v in heads_per_tail.items() if rr == r]
        th = [len(v) for (rr, _), v in tails_per_head.items() if rr == r]
        lef[r] = np.mean(ht) if ht else 0
        rig[r] = np.mean(th) if th else 0

    def category(r):
        one_head = lef[r] < args.threshold
        one_tail = rig[r] < args.threshold
        return {"11": one_head and one_tail, "1n": one_head and not one_tail,
                "n1": not one_head and one_tail, "nn": not (one_head or one_tail)}

    out_dir = args.output_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    names = {"11": "1-1.txt", "1n": "1-n.txt", "n1": "n-1.txt", "nn": "n-n.txt"}
    buckets = {k: [] for k in names}
    for i, (h, t, r) in enumerate(data.test):
        for k, hit in category(r).items():
            if hit:
                buckets[k].append(i)
    for k, fname in names.items():
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(f"{len(buckets[k])}\n")
            for i in buckets[k]:
                f.write(f"{i}\n")
        print(f"{fname}: {len(buckets[k])} test triples")


if __name__ == "__main__":
    main()

"""Render KGE_RESULTS.jsonl as a markdown table next to the published numbers.

    python -m skghoi_torch.tools.kge_results_table [KGE_RESULTS.jsonl]

Each ledger line carries the exact CLI + seed; this view keeps only the
headline comparison (last run per (example, data) wins, so reruns after
fixes supersede earlier rows).  Published Hits@10(filter) targets:
``OpenKE/README.md:90-98``.

Mirrors ``skghoi_tpu.tools.kge_results_table``; host only.  It reads the rows
that ``skghoi_torch.tools.train_kge --json-out`` appends (the same keys as the
JAX tool's rows, with ``platform`` the device type) as well as JAX's.
"""

from __future__ import annotations

import json
import os
import sys

PUBLISHED = {
    ("transe", "FB15K237"): 0.476, ("transe", "WN18RR"): 0.512,
    ("transh", "FB15K237"): 0.490, ("transh", "WN18RR"): 0.507,
    ("transr", "FB15K237"): 0.511, ("transr", "WN18RR"): 0.519,
    ("transd", "FB15K237"): 0.487, ("transd", "WN18RR"): 0.508,
    ("distmult", "FB15K237"): 0.419, ("distmult", "WN18RR"): 0.479,
    ("complex", "FB15K237"): 0.426, ("complex", "WN18RR"): 0.485,
    ("rotate", "FB15K237"): 0.522, ("rotate", "WN18RR"): 0.565,
}


def main(argv=None):
    paths = argv or sys.argv[1:]
    if not paths:
        # The CPU hedge ledger (rows trained with jax_platforms=cpu when the
        # chip was unavailable) loads FIRST so a real-chip rerun of the same
        # example supersedes it; its rows are marked in the table.
        paths = [p for p in ("KGE_RESULTS_CPU.jsonl", "KGE_RESULTS.jsonl")
                 if os.path.exists(p)]
    rows = {}
    for path in paths:
        cpu = path.endswith("_CPU.jsonl")
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                rec["_cpu"] = cpu
                bench = os.path.basename(rec["data"].rstrip("/"))
                rows[(rec.get("example") or rec["model"], bench)] = rec

    print("| Example | Benchmark | Hits@10 | Published | Delta | MRR | steps/s |")
    print("|---|---|---|---|---|---|---|")
    for (example, bench), rec in sorted(rows.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        pub = PUBLISHED.get((rec["model"], bench))
        delta = f"{rec['hit10'] - pub:+.3f}" if pub is not None else "-"
        pub_s = f"{pub:.3f}" if pub is not None else "-"
        tag = " (cpu hedge)" if rec.get("_cpu") else ""
        print(
            f"| {example}{tag} | {bench} | **{rec['hit10']:.3f}** | {pub_s} | {delta} "
            f"| {rec['mrr']:.3f} | {rec['steps_per_second']:.0f} |"
        )


if __name__ == "__main__":
    main()

"""Readings of ``chip_smoke.py`` phase 13e's bfloat16 check over seeds.

For each seed, random DETR-R50 weights and a batch of eight 832x1344 images
go through ``chip_smoke.stage1_detr_bf16`` with its factor lifted: per image
and output, the error of the bfloat16 model on the card against the
bfloat16 model on the CPU, the card's own bfloat16-against-float32 gap, and
their ratio, which ``S1_BF16_FACTOR`` bounds.  One JSON line a seed, then
the largest and median ratio.  Needs a CUDA card.

    python3 scripts/detr_bf16_readings.py [SEEDS]
"""

import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(seeds: int = 6) -> int:
    if not torch.cuda.is_available():
        print("detr_bf16_readings: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    cs.S1_BF16_FACTOR = math.inf
    rows = []
    for seed in range(seeds):
        t0 = time.perf_counter()
        d = cs.stage1_detr_bf16(seed)
        row = dict(seed=seed, s=time.perf_counter() - t0, cpu_s=d["cpu_s"], dtypes=d["dtypes"],
                   **{k: [(x["err"], x["gap"], x["ratio"]) for x in d[k]]
                      for k in ("logits", "boxes")})
        rows.append(row)
        print(json.dumps(row), flush=True)
    ratios = sorted(r[2] for row in rows for k in ("logits", "boxes") for r in row[k])
    print(json.dumps(dict(readings=len(ratios), max=ratios[-1], median=ratios[len(ratios) // 2],
                          logits_max=max(r[2] for row in rows for r in row["logits"]),
                          boxes_max=max(r[2] for row in rows for r in row["boxes"]))))
    return 0


if __name__ == "__main__":
    sys.exit(main(*map(int, sys.argv[1:])))

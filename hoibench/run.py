"""Run one cell of the benchmark once and print its result line.

    python3 -m hoibench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs the CUDA card(s) the cell asks for: without them it exits with code 2
and prints no result.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number compared
for ``correct`` beside its limit); the last lines of standard error give the
same numbers.
"""

from __future__ import annotations

import argparse
import json
import sys

from hoibench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    benchmark = harness.load_benchmark()
    cell = harness.load_cell(benchmark, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"hoibench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run_cell(cell, benchmark, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0))
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"hoibench: the run loaded {leaked}", file=sys.stderr)
        return 3
    print(json.dumps(harness.finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that the limits of ``correct`` are set from, on the card at
the cell's own size, many seeds in one process:

    python3 -m hoibench.readings --workload <cell> --seeds 1 2 3 [--control fp8]
        [--fault unchanged|half_batch|altered_answer] [--seconds 2]

Each seed runs the cell's set-up, a short window at the cell's load (long
enough to finish the requests or batches a run's check samples), and the
check; ``--control`` puts the reference in that precision in the program's
place, ``--fault`` plants a fault of ``hoibench.faults`` under the timed
path.  One JSON line a seed: its numbers, and whether they pass the limits.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from hoibench import faults, harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, type=int, nargs="+")
    p.add_argument("--control", default=None)
    p.add_argument("--fault", default=None, choices=sorted(faults.PLANTS))
    p.add_argument("--seconds", default=2.0, type=float)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    cell = harness.load_cell(harness.load_benchmark(), args.workload)

    import torch

    if not torch.cuda.is_available():
        print("hoibench.readings: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    module = harness.load_driver(cell["driver"])
    from hoibench.checks import judge

    for seed in args.seeds:
        t0 = time.perf_counter()
        driver = module.Driver(cell, seed, device)
        with faults.plant(args.fault, module) if args.fault else contextlib.nullcontext():
            driver.setup()
            driver.window(args.seconds)
        driver.release()
        readings = driver.check(args.control)
        checks = judge(readings, cell["limits"])
        print(json.dumps(dict(workload=args.workload, seed=seed, control=args.control,
                              fault=args.fault, attempted=driver.attempted, readings=readings,
                              passes=all(c["ok"] for c in checks.values()),
                              seconds=time.perf_counter() - t0)), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/bin/bash
# Serving throughput of two checkouts of the port, in turns on one card:
#   scripts/port_eval_ab.sh OTHER_CHECKOUT [REQUESTS]
# runs chip_smoke.py's main path (phase 4: the bf16 SCG at 832x1344, batch 8)
# for OTHER_CHECKOUT, this checkout, this checkout, OTHER_CHECKOUT, each in a
# fresh process, and prints each run's per-request times, img/s, profile and
# stage times, then one traced bf16 train step after three untimed ones
# ([ab-trace]: its wall ms, device busy ms and ops, idle share, and the
# host's CUDA runtime calls by time).  The train step's rate is the
# benchmark cell's: `python3 -m hoibench.run --workload scg_r50.train_b8`.
# OTHER_CHECKOUT is e.g. `git archive` of the parent unpacked into a
# directory that .gitignore lists.
set -euo pipefail
other=$(cd "$1" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
requests=${2:-20}
run() {
  (cd "$1" && REQUESTS="$requests" python3 - <<'PY'
import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402
from skghoi_torch.ops.roi_align_cuda import roi_align_cuda  # noqa: E402

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
roi_align_cuda.build()
print(f"[ab] {os.getcwd()}", flush=True)
chip_smoke.phase_main(int(os.environ["REQUESTS"]), os.path.join(os.getcwd(), "_ab_profile"))

import time  # noqa: E402

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from skghoi_torch.entry import train_entry  # noqa: E402

step, (batch, generator) = train_entry(device="cuda")
for _ in range(3):
    step(batch, generator)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    step(batch, generator)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
events = prof.key_averages()
device = chip_smoke.device_events(events)
busy_ms = sum(e.self_device_time_total for e in device) / 1e3
runtime = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key) for e in events
                  if e.device_type == DeviceType.CPU and e.key.startswith("cuda")), reverse=True)
print(f"[ab-trace] one traced bf16 train step: {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms in "
      f"{sum(e.count for e in device)} device ops, idle {max(0.0, 1 - busy_ms / wall_ms):.1%}; "
      f"host CUDA runtime calls (ms, count): "
      f"{[(k, round(ms, 3), n) for ms, n, k in runtime[:8]]}", flush=True)
PY
  )
}
for d in "$other" "$here" "$here" "$other"; do run "$d"; done

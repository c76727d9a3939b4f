"""One traced window: what ran on the device, when, and what the host did.

The harness wraps a bounded number of units (steps, batches or requests) in
``torch.profiler`` (CPU and CUDA activity) inside one ``hoibench.window``
range, which ends after a synchronise.  :class:`Trace` keeps, from the
profiler's events and in memory (no file is written):

- ``device``: the device operations (kernels, copies, memsets), without the
  device rows of ``record_function`` ranges, which span kernels already
  counted;
- ``busy_s``: the union of their intervals inside the window;
- ``window_s``: the window range's length;
- ``launches``: the host's kernel-launch API calls (``cudaLaunchKernel*``,
  ``cuLaunchKernel*``);
- the idle gaps between device work, each named by the harness span and the
  innermost host operation under its start.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "hoibench.window"
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")


@contextlib.contextmanager
def span(name: str):
    """A ``record_function`` range named ``hoibench.<name>``."""
    import torch

    with torch.profiler.record_function(f"hoibench.{name}"):
        yield


class Trace:
    def __init__(self, events):
        from torch.autograd import DeviceType

        window = [e for e in events if e.name == WINDOW]
        if not window:
            raise RuntimeError(f"no {WINDOW} range in the trace")
        self.t0, self.t1 = window[0].time_range.start, window[0].time_range.end
        self.window_s = (self.t1 - self.t0) / 1e6
        self.device: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        self.launches = 0
        for e in events:
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False) or e.name.startswith("hoibench."):
                    continue
                self.device.append((e.name, start, end))
            elif self.t0 <= start <= self.t1:
                self.host.append((e.name, start, end))
                if e.name.startswith(LAUNCH_PREFIXES):
                    self.launches += 1
        self.device.sort(key=lambda d: d[1])
        self.busy = self._union()
        self.busy_s = sum(min(b, self.t1) - max(a, self.t0) for a, b in self.busy
                          if b > self.t0 and a < self.t1) / 1e6

    def _union(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, a, b in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def kernels(self, pattern: str) -> List[float]:
        """Durations (s) of the device operations whose name holds ``pattern``,
        in launch order."""
        return [(b - a) / 1e6 for n, a, b in self.device if pattern in n]

    def device_ops(self, top: int = 10) -> List[list]:
        total: Dict[str, float] = defaultdict(float)
        for n, a, b in self.device:
            total[n[:160]] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest stretches of the window with no device work, by the
        harness span and the innermost host operation running as each began."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(max(a, self.t0), min(b, self.t1)) for a, b in zip(edges[::2], edges[1::2])]
        gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:top]
        out = []
        for a, b in gaps:
            under = [(e - s, n) for n, s, e in self.host if s <= a < e]
            spans = [u for u in under if u[1].startswith("hoibench.")]
            ops = [u for u in under if not u[1].startswith("hoibench.")]
            name = "/".join(min(x)[1] for x in (spans, ops) if x) or "no host operation"
            out.append([name[:160], (b - a) / 1e6])
        return out


def launches_per_unit(ctx) -> Optional[float]:
    """Launch API rows of the traced window per traced unit."""
    if not ctx.trace.launches:
        return None
    return ctx.trace.launches / ctx.units

"""Profiling: a torch.profiler trace and wall-clock step timing.

Mirrors ``skghoi_tpu.utils.profiling``: ``trace`` wraps ``torch.profiler``
(host and, where a card is present, CUDA activity) and writes a Chrome trace
(open it in ``chrome://tracing`` or Perfetto) into ``log_dir``; ``StepTimer``
gives HandyTimer-style wall-clock spans with summary stats.  The timer reads
the host clock only: a caller that times work on the card synchronises
(``torch.cuda.synchronize()``) before the span ends.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Deque, Optional


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Capture a torch.profiler trace of the enclosed block into
    ``log_dir/trace_<pid>_<n>.json``.

    Usage::

        with trace("/tmp/profile"):
            train_step(...)
    """
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


class StepTimer:
    """Rolling wall-clock timer (HandyTimer replacement, ``utils.py:232-246``)."""

    def __init__(self, maxlen: int = 100):
        self._durations: Deque[float] = deque(maxlen=maxlen)
        self._start: Optional[float] = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._durations.append(time.perf_counter() - self._start)
        self._start = None

    def __getitem__(self, i: int) -> float:
        return list(self._durations)[i]

    def mean(self) -> float:
        return sum(self._durations) / max(len(self._durations), 1)

    def last(self) -> float:
        return self._durations[-1] if self._durations else 0.0

    def rate(self, units_per_step: float = 1.0) -> float:
        m = self.mean()
        return units_per_step / m if m > 0 else 0.0

"""Profiling: a torch.profiler trace, and the program's named spans.

``trace`` mirrors ``skghoi_tpu.utils.profiling.trace``: it wraps
``torch.profiler`` (host and, where a card is present, CUDA activity) and
writes a Chrome trace (open it in ``chrome://tracing`` or Perfetto) into
``log_dir``.

``span(name)`` marks one layer of the program as a ``record_function``
range named ``skghoi.<name>``, in whatever ``torch.profiler`` session is
recording: ``trace``, ``perf_report --trace`` or a benchmark's traced
window, on the clock of the device rows beside it.  With no session
recording it returns one shared ``nullcontext``: one boolean check, no
dispatcher call, no allocation.  Spans mark layer boundaries only, never
the steps of a per-item loop.  Every name is in ``SPANS``.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import ProfilerActivity, profile, record_function

SPANS = (
    "to_device",  # data.factory.to_device: the batch to the card
    "forward",  # parallel.train_step and tools.train_detector: the model call
    "resnet50",  # models.resnet.ResNet50.forward, shared by the SCG and the detectors
    "filter",  # models.interaction_head.filter_detections, its NMS included
    "backward",  # parallel.train_step and tools.train_detector: the losses' backward
    "guard",  # parallel.train_step: the NaN guard's host read
    "optimizer",  # parallel.train_step and tools.train_detector: AdamW's step
    "decoder",  # detect.adamixer.AdaMixerDecoder.forward
    "sample",  # detect.adamixer: each stage's sample_groups
    "mixing",  # detect.adamixer.AdaptiveMixing.forward
    "match",  # detect.adamixer.compute_assignments: the costs, their copy, scipy
    "ground_truth",  # tools.train_detector.train_batch: the GT, AdaMixer's host de-duplication
    "set_loss",  # tools.train_detector: the assignments to the card, AdaMixer's set loss
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """The range ``skghoi.<name>`` while a profiler records, else a no-op."""
    if _profiler_enabled():
        return record_function(f"skghoi.{name}")
    return _OFF


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

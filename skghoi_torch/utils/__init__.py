"""Observability: profiling hooks, timers, logging helpers."""

from skghoi_torch.utils.logging import get_logger
from skghoi_torch.utils.profiling import StepTimer, trace

__all__ = ["StepTimer", "trace", "get_logger"]

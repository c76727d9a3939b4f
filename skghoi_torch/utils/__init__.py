"""Observability: profiling hooks, logging helpers."""

from skghoi_torch.utils.logging import get_logger
from skghoi_torch.utils.profiling import trace

__all__ = ["trace", "get_logger"]

"""Logging helpers: rank-0-only logging for data-parallel runs.

Mirrors ``skghoi_tpu.utils.logging``: one stdlib logger, silenced (level
``ERROR``) on every process but rank 0 of the process group, so a
data-parallel run logs once.  The rank comes from
:func:`skghoi_torch.parallel.distributed.is_main` (rank 0 when no group is
initialised).
"""

from __future__ import annotations

import logging
import sys

from skghoi_torch.parallel.distributed import is_main


def get_logger(name: str = "skghoi_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(level if is_main() else logging.ERROR)
    return logger

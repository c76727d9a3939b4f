"""Device selection shared by the port's entry points.

The port runs on a CUDA card.  An entry point takes the CPU only when its
caller names it (``device="cpu"``, as the tests do); with no card and no
explicit CPU it raises instead of falling back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "skghoi_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work on a CUDA ``device``; a no-op on the
    CPU, whose ops return when done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)

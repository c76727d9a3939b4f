"""Torch/mmdet state-dict layout of the AdaMixer mixing block.

Mirrors ``skghoi_tpu.detect.adamixer_convert``.  The mmdet-idiom twin of the
mixing block (``nn.Linear`` generators ``channel_mixer`` / ``spatial_mixer``,
``nn.LayerNorm`` ``ln_c`` / ``ln_s``, ``out_proj``) names its parameters as
the port's :class:`~skghoi_torch.detect.adamixer.AdaptiveMixing` does, so the
conversion is a selection under a prefix: this is where a real mmdet
AdaMixer checkpoint's mixing weights land.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from skghoi_torch.weights import cpu_float32

MIXING_MODULES = ("channel_mixer", "spatial_mixer", "ln_c", "ln_s", "out_proj")


def load_torch_mixing(state_dict: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """The mixing block's weights under ``prefix`` in a torch ``state_dict``
    -> the ``state_dict`` of :class:`AdaptiveMixing` (float32 CPU tensors)."""
    return {f"{m}.{t}": cpu_float32(state_dict[f"{prefix}{m}.{t}"])
            for m in MIXING_MODULES for t in ("weight", "bias")}

"""Seeded weights, made on the device in a few large draws.

The reference model, built on the meta device, gives every tensor's name,
shape and how the seed fills it (its ``init_kinds``).  One normal and one
uniform draw from a ``torch.Generator`` on the device cover every random
tensor, each then scaled and offset in place; the result is one float32
state dict that loads into the program and into the reference alike.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Tensor = torch.Tensor


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of a run's seed."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32, *stream.encode()]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_state(meta_model: torch.nn.Module, kinds: Dict[str, tuple], seed: int,
               device) -> Dict[str, Tensor]:
    """Every tensor of ``meta_model.state_dict()`` as float32 on ``device``."""
    shapes = {k: tuple(v.shape) for k, v in meta_model.state_dict().items()}
    missing = sorted(set(shapes) - set(kinds))
    if missing:
        raise KeyError(f"no init kind for {missing[:5]}")
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    state = {}
    for kind in ("normal", "uniform", "const"):
        names = [k for k in shapes if kinds[k][0] == kind]
        sizes = [int(np.prod(shapes[k])) for k in names]
        if not names:
            continue
        values = torch.tensor([float(kinds[k][1]) for k in names], device=device)
        offsets = torch.tensor([float(kinds[k][2]) if len(kinds[k]) > 2 else 0.0 for k in names],
                               device=device)
        if kind == "normal":
            flat = torch.randn(sum(sizes), generator=g, device=device)
        elif kind == "uniform":
            flat = torch.rand(sum(sizes), generator=g, device=device).mul_(2.0).sub_(1.0)
        else:
            flat = torch.ones(sum(sizes), device=device)
        # One scale and offset per tensor, spread over its entries: one
        # multiply and one add for all.
        owner = torch.repeat_interleave(torch.arange(len(sizes), device=device),
                                        torch.tensor(sizes, dtype=torch.int64, device=device))
        flat.mul_(values[owner]).add_(offsets[owner])
        state.update((k, part.view(shapes[k])) for k, part in zip(names, flat.split(sizes)))
    return {k: state[k] for k in shapes}

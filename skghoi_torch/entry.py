"""Entry points: the SCG network with seeded weights, and a synthetic batch.

``make_batch`` draws the same numbers from the same numpy seed as the JAX
package's ``__graft_entry__._make_batch``, so both frameworks see the same
images and detections.  ``entry()`` returns the eval forward on the flagship
model with a one-image 832x1344 batch, as the JAX ``entry()`` does;
``train_entry()`` returns the train step on the batch that ``bench.py
--train`` uses (832x1344, batch 8, with targets).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from skghoi_torch import constants as C
from skghoi_torch.data.structures import HOIBatch, HOITargets
from skghoi_torch.device import resolve_device
from skghoi_torch.models.scg import SpatiallyConditionedGraph
from skghoi_torch.parallel.train_step import build_train_step
from skghoi_torch.train.optimizer import build_optimizer
from skghoi_torch.weights import init_parameters

Device = Optional[Union[str, torch.device]]


def make_batch(batch_size: int, canvas: Tuple[int, int], num_dets: int = 32, num_gt: int = 4,
               with_targets: bool = False, seed: int = 0, tall_frac: float = 0.1,
               device: Device = None) -> HOIBatch:
    """Numpy-seeded synthetic ``HOIBatch`` on ``device`` (default ``cuda``).

    Detection geometry: log-uniform scale, aspect mostly in [1/3, 3], and a
    ``tall_frac`` share of tall outliers (aspect 4-6, standing persons).
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    h, w = canvas

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

    def i64(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)

    images = f32(rng.uniform(0, 1, (batch_size, h, w, 3)))
    sizes = f32(np.tile([[h, w]], (batch_size, 1)))

    def boxes(n):
        xy = rng.uniform(0, min(h, w) * 0.4, (batch_size, n, 2))
        scale = np.exp(rng.uniform(np.log(16), np.log(min(h, w) * 0.35), (batch_size, n)))
        log_a = rng.uniform(np.log(1 / 3), np.log(3.0), (batch_size, n))
        tall = rng.uniform(size=(batch_size, n)) < tall_frac
        log_a = np.where(tall, np.log(rng.uniform(4.0, 6.0, (batch_size, n))), log_a)
        wh = np.stack([scale / np.exp(log_a / 2), scale * np.exp(log_a / 2)], -1)
        return f32(np.concatenate([xy, np.minimum(xy + wh, [[w - 1, h - 1]])], -1))

    det_labels = rng.integers(0, 80, (batch_size, num_dets))
    det_labels[:, :6] = C.HICO_HUMAN_IDX
    targets = None
    if with_targets:
        targets = HOITargets(
            boxes_h=boxes(num_gt),
            boxes_o=boxes(num_gt),
            object=i64(rng.integers(0, 80, (batch_size, num_gt))),
            labels=i64(rng.integers(0, 117, (batch_size, num_gt))),
            valid=torch.ones((batch_size, num_gt), dtype=torch.bool, device=device),
        )
    det_boxes = boxes(num_dets)
    det_scores = f32(rng.uniform(0.1, 1.0, (batch_size, num_dets)))
    return HOIBatch(images, sizes, sizes, det_boxes, i64(det_labels), det_scores,
                    torch.ones((batch_size, num_dets), dtype=torch.bool, device=device), targets)


def verb_mask(seed: int = 0, device: Device = None) -> torch.Tensor:
    """Seeded ``[80, 117]`` float object->verb validity mask."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.uniform(size=(80, 117)) < 0.25).astype(np.float32)).to(device)


def build_model(dtype: torch.dtype = torch.float32, device: Device = None, seed: int = 0,
                **kwargs) -> SpatiallyConditionedGraph:
    """The SCG network in eval mode with seeded random weights, on ``device``
    (default ``cuda``)."""
    device = resolve_device(device)
    model = init_parameters(SpatiallyConditionedGraph(dtype=dtype, device="cpu", **kwargs), seed)
    return model.to(device).eval()


def entry(device: Device = None, dtype: torch.dtype = torch.bfloat16):
    """``(fn, (batch,))``: the eval forward of the flagship model on a
    one-image 832x1344 batch; ``fn`` returns the ``[1, 15, 30, 117]`` scores."""
    model = build_model(dtype=dtype, device=device)
    ovm = verb_mask(device=device)
    batch = make_batch(1, C.CANVAS_LANDSCAPE, device=device)

    @torch.no_grad()
    def fn(batch: HOIBatch) -> torch.Tensor:
        return model(batch, ovm).scores

    return fn, (batch,)


def train_entry(device: Device = None, dtype: torch.dtype = torch.bfloat16):
    """``(step, (batch, generator))``: the train step of the flagship model
    (seeded weights, ``frozen_stages=1``, two-group AdamW at the reference
    lr, all three losses) on a synthetic 832x1344 batch with targets, and a
    seeded ``torch.Generator`` on the device for the TransH sampling noise.
    ``step(batch, generator)`` returns ``(total, losses, out, applied)``."""
    device = resolve_device(device)
    model = build_model(dtype=dtype, device=device)
    step = build_train_step(model, build_optimizer(model), verb_mask(device=device))
    batch = make_batch(8, C.CANVAS_LANDSCAPE, with_targets=True, device=device)
    return step, (batch, torch.Generator(device=device).manual_seed(1))

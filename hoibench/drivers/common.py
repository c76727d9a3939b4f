"""What the SCG drivers share: the batch in both sides' forms, the weights,
the program's model, and the reference's model."""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from hoibench.reference.layers import quantizer
from hoibench.reference.scg import SCG
from hoibench.traffic import make_pool, object_verb_mask
from hoibench.weights import make_state
from skghoi_torch.data.structures import HOIBatch, HOITargets
from skghoi_torch.models.scg import SpatiallyConditionedGraph
from skghoi_torch.ops.roi_align_cuda import roi_align_cuda

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
BATCH_KEYS = ("images", "image_sizes", "original_sizes", "det_boxes", "det_labels",
              "det_scores", "det_valid")
TARGET_KEYS = ("gt_boxes_h", "gt_boxes_o", "gt_object", "gt_labels", "gt_valid")


def as_hoibatch(b: Dict[str, np.ndarray]) -> HOIBatch:
    """A pool batch as the loader's collated numpy ``HOIBatch``."""
    targets = HOITargets(*(b[k] for k in TARGET_KEYS)) if "gt_valid" in b else None
    return HOIBatch(*(b[k] for k in BATCH_KEYS), targets)


def reference_batch(b: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A pool batch as the reference reads it (int64 labels)."""
    out = {}
    for k, v in b.items():
        t = torch.from_numpy(v)
        out[k] = (t.long() if t.dtype == torch.int32 else t).to(device)
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SCGCell:
    """The pool, the object-verb mask, the seeded weights and both models of
    an SCG cell."""

    def __init__(self, cell: dict, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell["config_params"], cell["traffic_params"]
        self.attempted = self.failed = 0
        self.compile_s = 0.0

    def make_inputs(self) -> None:
        self.pool = make_pool(self.traffic, self.seed, self.device)
        self.ovm_np = object_verb_mask(self.config["interactions"], self.seed)

    def reference_model(self, precision: str = "float32", device=None) -> SCG:
        with torch.device(device or self.device):
            return SCG(self.config["frozen_stages"], quantizer(precision))

    def state(self) -> Dict[str, torch.Tensor]:
        meta = self.reference_model(device="meta")
        return make_state(meta, meta.init_kinds(), self.seed, self.device)

    def build_kernel(self) -> None:
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            roi_align_cuda.build()
            self.compile_s = time.perf_counter() - t0

    def program_model(self) -> SpatiallyConditionedGraph:
        with torch.device(self.device):
            model = SpatiallyConditionedGraph(dtype=DTYPES[self.config["compute_dtype"]],
                                              device=self.device,
                                              frozen_stages=self.config["frozen_stages"])
        model.load_state_dict(self.state())
        return model.eval()

    def ovm(self) -> torch.Tensor:
        return torch.from_numpy(self.ovm_np).to(self.device)

    def map_shapes(self, canvas, batch: int, channels: int = 256):
        return [(batch, canvas[0] // s, canvas[1] // s, channels) for s in (4, 8, 16, 32)]

    def reference(self, precision: Optional[str] = None):
        """The reference (or, with ``precision``, the control) with the seed's weights."""
        model = self.reference_model(precision or "float32")
        model.load_state_dict(self.state())
        return model

"""DETR-R50 stage-1 detection over a dataset, closed loop: each batch of
normalised images comes from a pinned host pool, is copied to the card
without blocking, goes through the program's ``DETR.raw`` (the network:
class logits and normalised boxes), and both come back to the host.

The check takes a sample, drawn from the seed, of the batches the window
finished and runs the reference DETR on their images.  Its numbers:
``logit_gap`` and ``box_gap``, each the worst sampled batch's largest
difference over the reference's largest magnitude, and ``logit_image_gap``
and ``box_image_gap``, the same differences over the reference's largest
departure of one image's output from the batch's mean, which an output
that belongs to another image of the batch moves by about its whole size.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hoibench.checks import image_max_gap, scaled_max_gap
from hoibench.drivers.common import DTYPES, sync
from hoibench.reference.detr import DETR as ReferenceDETR
from hoibench.reference.layers import quantizer
from hoibench.trace import span
from hoibench.traffic import make_pool
from hoibench.weights import make_state, sub_seed
from skghoi_torch.detect.detr import DETR


class Driver:
    def __init__(self, cell: dict, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell["config_params"], cell["traffic_params"]
        self.attempted = self.failed = 0
        self.compile_s = 0.0

    def reference_model(self, precision: str = "float32", device=None) -> ReferenceDETR:
        c = self.config
        with torch.device(device or self.device):
            return ReferenceDETR(c["num_classes"], c["enc_layers"], c["num_queries"], quantizer(precision))

    def state(self):
        meta = self.reference_model(device="meta")
        return make_state(meta, meta.init_kinds(), self.seed, self.device)

    def setup(self) -> None:
        pool = make_pool(self.traffic, self.seed, self.device)
        pin = self.device.type == "cuda"
        self.pool = [torch.from_numpy(b["images"]) for b in pool]
        self.pool = [t.pin_memory() if pin else t for t in self.pool]
        c = self.config
        if c["enc_layers"] != c["dec_layers"]:
            raise ValueError("the program's DETR has as many decoder as encoder layers")
        model = DETR(num_classes=c["num_classes"], num_layers=c["enc_layers"], num_queries=c["num_queries"],
                     dtype=DTYPES[c["compute_dtype"]], device=self.device)
        model.load_state_dict(self.state())
        self.model = model.eval()
        self.i = 0
        self.answers = []
        for _ in range(2):
            self._batch()
        self.answers = []
        sync(self.device)

    @torch.no_grad()
    def _batch(self) -> None:
        k = self.i % len(self.pool)
        self.i += 1
        with span("copy_in"):
            images = self.pool[k].to(self.device, non_blocking=True)
        with span("detr"):
            logits, boxes = self.model.raw(images)
        with span("copy_out"):
            self.answers.append((k, logits.cpu(), boxes.cpu()))

    def window(self, seconds: float) -> dict:
        sync(self.device)
        t0 = time.perf_counter()
        while True:
            self._batch()
            self.attempted += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        elapsed = time.perf_counter() - t0
        self.unit_s = elapsed / self.attempted
        return {"infer_img_per_s": self.attempted * self.traffic["batch"] / elapsed}

    def run_units(self, n: int) -> None:
        for _ in range(n):
            with span("batch"):
                self._batch()

    def release(self) -> None:
        rng = np.random.default_rng(sub_seed(self.seed, "sample"))
        pick = rng.choice(len(self.answers), min(self.cell["checked_batches"], len(self.answers)),
                          replace=False)
        self.sample = [self.answers[i] for i in sorted(pick)]
        self.model = self.answers = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def flop_fn(self, canvas):
        """The reference's forward of one batch at ``canvas``, on meta tensors."""

        def run():
            model = self.reference_model(device="meta")
            model(torch.empty((self.traffic["batch"], *canvas, 3), device="meta"))

        return run

    def check(self, control: str = None) -> dict:
        """Against the reference; with ``control`` (a precision), the
        reference in that precision takes the program's place."""
        state = self.state()
        model = self.reference_model()
        model.load_state_dict(state)
        lowp = None
        if control:
            lowp = self.reference_model(control)
            lowp.load_state_dict(state)
        gaps = dict(logit_gap=0.0, box_gap=0.0, logit_image_gap=0.0, box_image_gap=0.0)
        with torch.no_grad():
            for k, logits, boxes in self.sample:
                images = self.pool[k].to(self.device)
                want = model(images)
                if lowp is not None:
                    logits, boxes = (t.cpu() for t in lowp(images))
                for name, got, ref in (("logit", logits, want[0].cpu()), ("box", boxes, want[1].cpu())):
                    gaps[f"{name}_gap"] = max(gaps[f"{name}_gap"], scaled_max_gap(got, ref))
                    gaps[f"{name}_image_gap"] = max(gaps[f"{name}_image_gap"], image_max_gap(got, ref))
        return gaps

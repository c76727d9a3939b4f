"""SCG serving, closed loop, one client: each request is a one-image numpy
batch from the pool (no targets), sent through the program's
``data.factory.to_device`` and ``parallel.train_step.build_eval_step``; its
latency runs from the send to its ``[1, 15, 30, 117]`` scores on the host.

The check takes a sample, drawn from the seed, of the requests the window
finished, and runs the reference's eval forward on each one's input.  Its
number: ``score_gap`` (the worst request's largest score difference over
its largest reference score).  ``filter_slots`` (slots of the detection
filter that differ, with the human and box counts) is read beside it: the
filter computes in float32 on both sides, so the lower-precision control
cannot separate it from a sound run.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hoibench.checks import scaled_max_gap
from hoibench.drivers.common import SCGCell, as_hoibatch, reference_batch, sync
from hoibench.drivers.scg_train import _filter_slots
from hoibench.trace import span
from hoibench.weights import sub_seed
from skghoi_torch.data.factory import to_device
from skghoi_torch.parallel.train_step import build_eval_step


class Driver(SCGCell):
    def setup(self) -> None:
        self.make_inputs()
        self.build_kernel()
        self.eval_step = build_eval_step(self.program_model(), self.ovm())
        self.i = 0
        self.answers = []
        for b in self._warm_set():
            self._request(b)
        self.answers = []
        sync(self.device)

    def _warm_set(self):
        """Three requests of every canvas in the pool."""
        seen = {}
        for b in self.pool:
            c = b["images"].shape[1:3]
            if seen.get(c, 0) < 3:
                seen[c] = seen.get(c, 0) + 1
                yield b

    def _request(self, b) -> float:
        t0 = time.perf_counter()
        with span("to_device"):
            batch = to_device(as_hoibatch(b), self.device)
        with span("eval_step"):
            out = self.eval_step(batch)
        with span("read_scores"):
            scores = out.scores.cpu()
        latency = time.perf_counter() - t0
        self.answers.append((b, scores, dict(boxes=out.boxes, labels=out.object_class,
                                             n_h=out.n_h, n=out.n)))
        return latency

    def _next(self):
        b = self.pool[self.i % len(self.pool)]
        self.i += 1
        return b

    def window(self, seconds: float) -> dict:
        latencies = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            latencies.append(self._request(self._next()))
        self.attempted = len(latencies)
        self.unit_s = (time.perf_counter() - t0) / len(latencies)
        return {"serve_ms_p95": float(np.percentile(latencies, 95)) * 1e3}

    def run_units(self, n: int) -> None:
        for _ in range(n):
            with span("request"):
                self._request(self._next())

    def release(self) -> None:
        rng = np.random.default_rng(sub_seed(self.seed, "sample"))
        pick = rng.choice(len(self.answers), min(self.cell["checked_requests"], len(self.answers)),
                          replace=False)
        self.sample = [(b, s, {k: v.cpu() for k, v in f.items()})
                       for b, s, f in (self.answers[i] for i in sorted(pick))]
        self.eval_step = self.answers = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: str = None) -> dict:
        """Against the reference; with ``control`` (a precision), the
        reference in that precision takes the program's place."""
        model = self.reference()
        lowp = self.reference(control) if control else None
        ovm = self.ovm()
        score_gap, slots = 0.0, 0
        with torch.no_grad():
            for b, scores, filt in self.sample:
                out = model(reference_batch(b, self.device), ovm)
                if lowp is not None:
                    got = lowp(reference_batch(b, self.device), ovm)
                    scores = got["scores"].cpu()
                    filt = {k: got[k].cpu() for k in ("boxes", "labels", "n_h", "n")}
                score_gap = max(score_gap, scaled_max_gap(scores, out["scores"].cpu()))
                slots += _filter_slots(filt, {k: out[k].cpu() for k in ("boxes", "labels", "n_h", "n")})
        return dict(score_gap=score_gap, filter_slots=slots)

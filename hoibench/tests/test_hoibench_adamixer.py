"""The AdaMixer training cell, ``adamixer_r50.train_b4``, on the CPU: a whole
traced run through the harness at a tiny size (64x96, two images a batch,
12 queries, 2 stages, content 64) comes out correct; the control (the
reference with TF32 products in the program's place) and each fault of
``hoibench.adamixer_faults`` come out not correct under the cell's limits,
as does a program that trains a stage the configuration freezes or changes
AdamW's step after the window; and the five span readers on hand-built
traces (times in us)."""

from __future__ import annotations

from unittest import mock

import pytest
import torch

from hoibench import adamixer_faults, faults, harness
from hoibench.checks import judge
from hoibench.tests.test_hoibench_spans import _event
from hoibench.trace import Trace
from tiny import run_tiny, tiny_cell

CELL = "adamixer_r50.train_b4"
SMALL = dict(num_queries=12, num_stages=2, content_dim=64, in_points=8, out_points=16, ffn_dim=128)
READERS = ("sample_launches.adamixer", "decoder_launches.adamixer", "match_idle_ms.adamixer")


def _cell():
    return tiny_cell(CELL, **SMALL)


def test_the_sound_program_is_correct():
    r = run_tiny(_cell(), trace=True)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checks"]) == set(_cell()["limits"])
    # No device trace on the CPU: no device metric is read there.
    assert r["metrics"] == {}


def test_the_tf32_control_is_not_correct():
    c = _cell()
    d = harness.load_driver(c["driver"]).Driver(c, 13, torch.device("cpu"))
    d.setup()
    d.window(0.2)
    d.release()
    checks = judge(d.check("tf32"), c["limits"])
    assert not all(v["ok"] for v in checks.values()), checks


@pytest.mark.parametrize("fault", sorted(adamixer_faults.PLANTS))
def test_a_planted_fault_is_not_correct(fault):
    c = _cell()
    with adamixer_faults.extended(), faults.plant(fault, harness.load_driver(c["driver"])):
        r = run_tiny(c)
    assert r["correct"] is False, r["checks"]


def test_a_program_that_trains_a_frozen_stage_is_not_correct():
    c = _cell()
    module = harness.load_driver(c["driver"])
    real_model = module.Driver.program_model

    def program_model(self):
        model = real_model(self)
        model.backbone.backbone.frozen_stages = 0
        model.backbone.backbone.layer1.requires_grad_(True)
        return model

    with mock.patch.object(module.Driver, "program_model", program_model):
        r = run_tiny(c)
    assert r["correct"] is False and r["checks"]["frozen_moved"]["value"] > 0, r["checks"]


def test_a_late_update_that_differs_fails_the_late_change():
    """AdamW's learning rate halved after the window: the late gradients and
    losses are the reference's, the late change is not."""
    c = _cell()
    module = harness.load_driver(c["driver"])
    real_release = module.Driver.release

    def release(self):
        for group in self.opt.param_groups:
            group["lr"] *= 0.5
        return real_release(self)

    with mock.patch.object(module.Driver, "release", release):
        r = run_tiny(c)
    checks = r["checks"]
    assert r["correct"] is False, checks
    assert checks["late_change_gap"]["value"] > 0.4, checks
    assert checks["late_grad_gap"]["value"] <= checks["late_grad_gap"]["limit"], checks


def _events():
    """One step of 100 us: device busy 0-20, 40-60, 80-100."""
    return [
        _event("hoibench.window", 0.0, 100.0),
        _event("skghoi.forward", 0.0, 40.0),
        _event("skghoi.decoder", 5.0, 38.0),
        _event("skghoi.sample", 6.0, 10.0),
        _event("cudaLaunchKernel", 7.0, 7.5),
        _event("cudaLaunchKernel", 8.0, 8.5),
        _event("skghoi.mixing", 11.0, 15.0),
        _event("cudaLaunchKernel", 12.0, 12.5),
        _event("skghoi.match", 40.0, 70.0),
        _event("cudaLaunchKernel", 65.0, 65.5),
        _event("skghoi.backward", 70.0, 90.0),
        _event("cudaLaunchKernel", 75.0, 75.5),
        _event("kernel_a", 0.0, 20.0, device=True),
        _event("kernel_b", 40.0, 60.0, device=True),
        _event("kernel_c", 80.0, 100.0, device=True),
    ]


def test_readers_per_step():
    ctx = harness.Context(Trace(_events()), None, 2, None)
    got = {m: harness.load_reader(m).read(ctx) for m in READERS}
    # gaps: 20-40 begins under the decoder, 60-80 under the match (into the backward)
    assert got == pytest.approx({"sample_launches.adamixer": 1.0,
                                 "decoder_launches.adamixer": 1.5,
                                 "match_idle_ms.adamixer": 0.01})


HOST_READERS = ("ground_truth_idle_ms.adamixer", "set_loss_idle_ms.adamixer")


def _host_events():
    """One step of 100 us: the ground truth, the forward, the match, the set
    loss and the backward; device busy 0-2, 8-45, 48-52, 60-100."""
    return [
        _event("hoibench.window", 0.0, 100.0),
        _event("skghoi.ground_truth", 0.0, 10.0),
        _event("skghoi.forward", 10.0, 40.0),
        _event("skghoi.match", 40.0, 50.0),
        _event("skghoi.set_loss", 50.0, 70.0),
        _event("skghoi.backward", 70.0, 100.0),
        _event("kernel_a", 0.0, 2.0, device=True),
        _event("kernel_b", 8.0, 45.0, device=True),
        _event("kernel_c", 48.0, 52.0, device=True),
        _event("kernel_d", 60.0, 100.0, device=True),
    ]


def test_host_readers_per_step():
    """Gaps 2-8 under the ground truth, 45-48 under the match, 52-60 under
    the set loss; two steps."""
    ctx = harness.Context(Trace(_host_events()), None, 2, None)
    got = {m: harness.load_reader(m).read(ctx) for m in (*HOST_READERS, "match_idle_ms.adamixer")}
    assert got == pytest.approx({"ground_truth_idle_ms.adamixer": 0.003,
                                 "set_loss_idle_ms.adamixer": 0.004,
                                 "match_idle_ms.adamixer": 0.0015})


def test_host_readers_return_none_without_their_spans():
    tr = Trace([e for e in _host_events()
                if e.name not in ("skghoi.ground_truth", "skghoi.set_loss")])
    ctx = harness.Context(tr, None, 1, None)
    assert {m: harness.load_reader(m).read(ctx) for m in HOST_READERS} == dict.fromkeys(HOST_READERS)


def test_readers_return_none_without_their_spans():
    """The parent's program has no ``decoder``, ``sample`` or ``match`` span."""
    tr = Trace([e for e in _events() if e.name not in
                ("skghoi.decoder", "skghoi.sample", "skghoi.mixing", "skghoi.match")])
    ctx = harness.Context(tr, None, 1, None)
    assert {m: harness.load_reader(m).read(ctx) for m in READERS} == dict.fromkeys(READERS)

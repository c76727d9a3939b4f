"""The check fails what it must: each fault that a cell can have, planted
under the timed path of a whole run (the look for a card skipped), and the
control, the reference in float8 in the program's place, come out not
correct under the cell's limits; the sound program comes out correct."""

from __future__ import annotations

from unittest import mock

import pytest
import torch

from hoibench import faults, harness
from tiny import run_tiny, tiny_cell

CASES = [(cell, fault) for cell in ("scg_r50.train_b8", "scg_r50.serve_b1", "detr_r50.detect_b8")
         for fault in faults.FOR_DRIVER[tiny_cell(cell)["driver"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    c = tiny_cell(cell)
    with faults.plant(fault, harness.load_driver(c["driver"])):
        r = run_tiny(c)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "stale_inputs"])
def test_a_fault_of_the_window_alone_fails_the_late_steps(fault):
    """A train step that goes wrong only after set-up (it stops updating, or
    it replays the inputs of its first window step) passes steps 1-3 and
    fails a number of the late steps, which the window's own object drives."""
    c = tiny_cell("scg_r50.train_b8")
    module = harness.load_driver(c["driver"])
    real_setup = module.Driver.setup

    def setup(self):
        real_setup(self)
        if fault == "unchanged":
            self.opt.step = lambda closure=None: None

    if fault == "unchanged":
        plant = mock.patch.object(module.Driver, "setup", setup)
    else:
        plant = faults.plant(fault, module)
    with plant:
        r = run_tiny(c)
    checks = r["checks"]
    assert r["correct"] is False, checks
    early = ("loss_gap", "grad_gap", "change_gap", "filter_slots")
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in early), checks
    assert any(checks[k]["value"] > checks[k]["limit"] for k in checks if k.startswith("late_")), checks


def test_a_program_that_trains_a_frozen_stage_is_not_correct():
    """``frozen_moved`` reads the reference's frozen set, not the program's:
    a program that trains ``layer1`` (frozen stages 0, not 1) fails it."""
    c = tiny_cell("scg_r50.train_b8")
    module = harness.load_driver(c["driver"])
    real_model = module.Driver.program_model

    def program_model(self):
        model = real_model(self)
        model.detector.backbone.frozen_stages = 0
        model.detector.backbone.layer1.requires_grad_(True)
        return model

    with mock.patch.object(module.Driver, "program_model", program_model):
        r = run_tiny(c)
    assert r["correct"] is False and r["checks"]["frozen_moved"]["value"] > 0, r["checks"]


@pytest.mark.parametrize("cell", ["scg_r50.train_b8", "scg_r50.serve_b1", "detr_r50.detect_b8"])
def test_the_float8_control_is_not_correct(cell):
    c = tiny_cell(cell)
    d = harness.load_driver(c["driver"]).Driver(c, 13, torch.device("cpu"))
    d.setup()
    d.window(0.2)
    d.release()
    from hoibench.checks import judge

    checks = judge(d.check("fp8"), c["limits"])
    assert not all(v["ok"] for v in checks.values()), checks


@pytest.mark.parametrize("cell", ["scg_r50.train_b8", "scg_r50.serve_b1", "detr_r50.detect_b8"])
def test_the_sound_program_is_correct(cell):
    r = run_tiny(tiny_cell(cell))
    assert r["correct"] is True, r["checks"]

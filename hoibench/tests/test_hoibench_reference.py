"""The plain reference against the program's CPU path at a small canvas, both
in float32 with the same seeded weights and inputs: what the reference
computes is what the program computes."""

from __future__ import annotations

import pytest
import torch

from hoibench import harness
from tiny import tiny_cell


def _driver(name, **config):
    cell = tiny_cell(name, **config)
    return harness.load_driver(cell["driver"]).Driver(cell, 11, torch.device("cpu"))


def test_train_step_float32_matches_the_program():
    d = _driver("scg_r50.train_b8", compute_dtype="float32")
    d.setup()
    d.window(0.0)
    d.release()
    got = d.check()
    assert got["loss_gap"] < 1e-5 and got["filter_slots"] == 0 and got["frozen_moved"] == 0.0
    assert got["grad_gap"] < 1e-3 and got["change_gap"] < 1e-3
    assert got["late_loss_gap"] < 1e-5 and got["late_grad_gap"] < 1e-3 and got["late_change_gap"] < 1e-3
    # Every leaf that the reference's gradient moves has moved in the program.
    from hoibench.checks import moving_leaves

    moving = moving_leaves(d.reference_readings()["grads"])
    assert moving and all(d.program["change"][k] > 0 for k in moving)


@pytest.mark.parametrize("name", ["scg_r50.serve_b1", "detr_r50.detect_b8"])
def test_inference_float32_matches_the_program(name):
    d = _driver(name, compute_dtype="float32")
    d.setup()
    d.window(0.2)
    d.release()
    got = d.check()
    assert all(v < 1e-5 for v in got.values()), got
    # The answers compared are not empty.
    if name.startswith("scg"):
        assert any(float(s.abs().max()) > 0 for _, s, _ in d.sample)
    else:
        assert all(float(l.abs().max()) > 0 for _, l, _ in d.sample)


def test_the_reference_takes_nothing_the_program_made():
    """The reference's weights come from the seed again, not from the program."""
    d = _driver("scg_r50.serve_b1")
    a, b = d.state(), d.state()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(a.values(), b.values()))

"""Faults planted under a driver's timed path, to show that the check fails
them: ``plant(name, driver_module)`` patches the program's entry that the
driver calls, for as long as the context lasts.

- ``unchanged``: the train step runs its forward and backward and never
  updates, so the parameters and AdamW's state stay as they were;
- ``half_batch``: the program sees the first half of each batch only (the
  losses' means are over that half; a detector's outputs for the other half
  are copies of the first's);
- ``altered_answer``: one answer is changed where it is produced (the
  largest score of a request set to 0; one query's class logits reversed);
- ``stale_inputs``: from the end of set-up on, every train step gets the
  batch and noise of the first step after it, as a step captured once and
  replayed with inputs it no longer reads would.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

# The faults that each driver's cell can have.
FOR_DRIVER = {
    "scg_train": ("unchanged", "half_batch", "stale_inputs"),
    "scg_serve": ("altered_answer",),
    "detr_detect": ("half_batch", "altered_answer"),
}


class _NoUpdate:
    """An optimizer whose ``step`` does nothing."""

    def __init__(self, optimizer):
        self.param_groups, self.zero_grad = optimizer.param_groups, optimizer.zero_grad

    def step(self):
        return None


def _unchanged(module):
    real = module.build_train_step

    def build(model, optimizer, *args, **kwargs):
        return real(model, _NoUpdate(optimizer), *args, **kwargs)

    return mock.patch.object(module, "build_train_step", build)


def _half_batch(module):
    if hasattr(module, "DETR"):
        class HalfDETR(module.DETR):
            def raw(self, images):
                logits, boxes = super().raw(images[: len(images) // 2])
                return torch.cat([logits, logits]), torch.cat([boxes, boxes])

        return mock.patch.object(module, "DETR", HalfDETR)
    real = module.build_train_step

    def build(*args, **kwargs):
        step = real(*args, **kwargs)

        def half(batch, generator=None, gumbel=None):
            n = len(batch.images) // 2
            targets = type(batch.targets)(*(a[:n] for a in batch.targets))
            return step(type(batch)(*(a[:n] for a in batch[:-1]), targets), generator,
                        None if gumbel is None else gumbel[:n])

        half.model, half.optimizer = step.model, step.optimizer
        return half

    return mock.patch.object(module, "build_train_step", build)


def _altered_answer(module):
    if hasattr(module, "DETR"):
        class AlteredDETR(module.DETR):
            def raw(self, images):
                logits, boxes = super().raw(images)
                logits = logits.clone()
                logits[0, 0] = logits[0, 0].flip(-1)
                return logits, boxes

        return mock.patch.object(module, "DETR", AlteredDETR)
    real = module.build_eval_step

    def build(model, ovm):
        step = real(model, ovm)

        def altered(batch):
            out = step(batch)
            scores = out.scores.clone()
            scores.view(-1)[scores.view(-1).argmax()] = 0.0
            return out._replace(scores=scores)

        return altered

    return mock.patch.object(module, "build_eval_step", build)


def _stale_inputs(module):
    real_setup = module.Driver.setup

    def setup(self):
        real_setup(self)
        step, held = self.step, []

        def stale(batch, generator=None, gumbel=None):
            if not held:
                held.append((batch, gumbel))
            return step(held[0][0], generator, held[0][1])

        self.step = stale

    return mock.patch.object(module.Driver, "setup", setup)


PLANTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered_answer": _altered_answer,
          "stale_inputs": _stale_inputs}


@contextlib.contextmanager
def plant(name: str, module):
    with PLANTS[name](module):
        yield

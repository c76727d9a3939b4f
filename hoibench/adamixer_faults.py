"""Faults planted under the AdaMixer train driver's timed path (beside
``hoibench.faults``, whose ``plant`` takes these names too while this
module's ``extended`` context lasts):

- ``dropped_tap``: bilinear sampling drops its lower-right tap (weight
  ``wx * wy``), so every sampled value, forward and backward, lacks one of
  its four corners;
- ``adamixer_half_batch``: the step sees the first half of each batch only
  (images and ground truth; the set loss's count is that half's);
- ``adamixer_unchanged``: the step runs its forward, match and backward and
  never updates, so the parameters and AdamW's state stay as they were;
- ``scaled_offset_grad``, ``scaled_box_grad``: the gradient of one leaf, the
  first stage's sampling-offset generator (``OFFSET_LEAF``) or its box
  head's bias (``BOX_LEAF``), is doubled before AdamW takes it: a wrong
  adjoint of one leaf, which AdamW's update, scaled by the gradient's own
  size, all but hides.

Read them on the card at the cell's size like ``hoibench.readings``:

    python3 -m hoibench.adamixer_faults --workload adamixer_r50.train_b4 --seeds 1 2 3 --fault dropped_tap
"""

from __future__ import annotations

import contextlib
import sys
from unittest import mock

from hoibench import faults


def _dropped_tap(module):
    from skghoi_torch.detect import adamixer

    def three_taps(feat, h, w, x, y):
        xf, yf = x - 0.5, y - 0.5
        x0, y0 = xf.floor(), yf.floor()
        wx, wy = (xf - x0)[..., None], (yf - y0)[..., None]
        c = feat.shape[-1]

        def tap(ix, iy):
            idx = iy.long().clamp(0, h - 1) * w + ix.long().clamp(0, w - 1)
            return feat.gather(2, idx[..., None].expand(*idx.shape, c))

        top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
        return top * (1 - wy) + tap(x0, y0 + 1) * (1 - wx) * wy

    return mock.patch.object(adamixer, "_bilinear_sample", three_taps)


def _half_batch(module):
    real = module.build_adamixer_step

    def build(model, optimizer):
        step = real(model, optimizer)

        def half(images, gt_boxes, gt_labels, gt_valid):
            n = len(images) // 2
            return step(images[:n], gt_boxes[:n], gt_labels[:n], gt_valid[:n])

        half.model, half.optimizer = step.model, step.optimizer
        return half

    return mock.patch.object(module, "build_adamixer_step", build)


def _unchanged(module):
    real = module.build_adamixer_step

    def build(model, optimizer):
        return real(model, faults._NoUpdate(optimizer))

    return mock.patch.object(module, "build_adamixer_step", build)


OFFSET_LEAF = "decoder.stage0.offset_generator.weight"
BOX_LEAF = "decoder.stage0.fc_reg.bias"


def _scaled_grad(leaf):
    def plant(module):
        real = module.build_adamixer_step

        def build(model, optimizer):
            dict(model.named_parameters())[leaf].register_hook(lambda g: 2 * g)
            return real(model, optimizer)

        return mock.patch.object(module, "build_adamixer_step", build)

    return plant


PLANTS = {"dropped_tap": _dropped_tap, "adamixer_half_batch": _half_batch,
          "adamixer_unchanged": _unchanged, "scaled_offset_grad": _scaled_grad(OFFSET_LEAF),
          "scaled_box_grad": _scaled_grad(BOX_LEAF)}


@contextlib.contextmanager
def extended():
    """``hoibench.faults.PLANTS`` with these faults added, for as long as it lasts."""
    with mock.patch.dict(faults.PLANTS, PLANTS):
        yield


def main(argv=None) -> int:
    from hoibench import readings

    with extended():
        return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())

"""A fault planted on the card's own sampling route, beside
``hoibench.adamixer_faults`` (whose ``dropped_tap`` patches the eager
gathers, which the card no longer runs):

- ``kernel_dropped_tap``: the forward sampling kernel's output lacks the
  lower-right tap of every level (its bilinear weight ``wx * wy`` times the
  level's weight), the sum ``dropped_tap`` leaves; the adjoint kernel is the
  whole sampling's, as a forward kernel that skipped a tap would leave it.

It plants on the card only: the CPU samples with the eager gathers.  Read it
on the card at the cell's size like ``hoibench.readings``:

    python3 -m hoibench.adamixer_kernel_faults --workload adamixer_r50.train_b4 --seeds 1 2 3 --fault kernel_dropped_tap
"""

from __future__ import annotations

import contextlib
import sys
from unittest import mock

from hoibench import faults


def lower_right_taps(feats, hw, points, wts):
    """Each level's lower-right bilinear tap at ``points``' x, y, times its
    blend weight ``wx * wy`` and the level's weight in ``wts``, summed over
    the levels: ``[B, G, M, c]``."""
    from skghoi_torch.detect import adamixer

    out = 0
    for li, (feat, (h, w)) in enumerate(zip(feats, hw)):
        stride = adamixer.LEVEL_STRIDES[li]
        idx, wx, wy = adamixer._taps(h, w, points[..., 0] / stride, points[..., 1] / stride)
        tap = feat.gather(2, idx[3][..., None].expand(*idx[3].shape, feat.shape[-1]))
        out = out + tap * wx * wy * wts[..., li:li + 1]
    return out


class DroppedTapKernel:
    """The sampling kernels ``kernel`` with a forward that drops each level's
    lower-right tap; everything else (the adjoint, the counters) is the
    kernel's."""

    def __init__(self, kernel):
        self.kernel = kernel

    def __getattr__(self, name):
        return getattr(self.kernel, name)

    def __call__(self, feats, hw, inv_strides, points, wts):
        out = self.kernel(feats, hw, inv_strides, points, wts)
        return out - lower_right_taps(feats, hw, points, wts)


def _kernel_dropped_tap(module):
    from skghoi_torch.detect import adamixer

    return mock.patch.object(adamixer, "sample_cuda", DroppedTapKernel(adamixer.sample_cuda))


PLANTS = {"kernel_dropped_tap": _kernel_dropped_tap}


@contextlib.contextmanager
def extended():
    """``hoibench.faults.PLANTS`` with this fault added, for as long as it lasts."""
    with mock.patch.dict(faults.PLANTS, PLANTS):
        yield


def main(argv=None) -> int:
    from hoibench import readings

    with extended():
        return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())

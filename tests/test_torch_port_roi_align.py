"""The port's plain multi-scale RoIAlign vs the JAX package's three forms.

The gather reference ``multiscale_roi_align``, the exact Pallas path
``roi_align_exact`` and the raw kernel ``pallas_multiscale_roi_align`` (both
in Pallas interpret mode) on the fixtures of ``test_pallas_roi_align.py``,
including the 832x1344 window-overflow boxes; rtol/atol 1e-4.  The CUDA
kernel itself is held against this plain version on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skghoi_tpu.ops.pallas_roi_align import pallas_multiscale_roi_align, roi_align_exact
from skghoi_tpu.ops.roi_align import fpn_level_assignment as jax_levels
from skghoi_tpu.ops.roi_align import multiscale_roi_align as jax_gather
from skghoi_torch.ops.roi_align import fpn_level_assignment, multiscale_roi_align
from skghoi_torch.ops.roi_align_cuda import roi_align_auto, roi_align_cuda

torch.set_num_threads(2)

EDGE = [
    [0.0, 0.0, 383.0, 255.0],      # whole image -> coarsest level
    [-20.0, -20.0, 30.0, 30.0],    # partially outside
    [370.0, 240.0, 383.0, 255.0],  # bottom-right corner
    [5.0, 5.0, 6.0, 6.0],          # tiny -> clamped roi
    [0.0, 0.0, 0.0, 0.0],          # degenerate (padding slot)
    [100.0, 50.0, 220.0, 200.0],
]
EXTREME = [
    [0.0, 100.0, 380.0, 112.0],    # 380x12: aspect ~32, wide
    [200.0, 0.0, 214.0, 250.0],    # tall standing-person-like
    [0.0, 0.0, 383.0, 30.0],       # full-width banner
    [-10.0, -10.0, 390.0, 260.0],  # larger than the image
    [50.0, 50.0, 51.0, 51.0],
    [0.0, 0.0, 0.0, 0.0],
]
OVERFLOW = [
    [100.0, 300.0, 1000.0, 400.0],  # 900x100 -> P4, overflows the TPU window
    [40.0, 700.0, 1340.0, 760.0],   # 1300x60 thin strip
    [200.0, 200.0, 400.0, 500.0],   # ordinary box
    [0.0, 0.0, 0.0, 0.0],           # padding slot
]


def make_maps(rng, b, canvas, c):
    if isinstance(rng, int):
        rng = np.random.default_rng(rng)
    return [rng.normal(size=(b, canvas[0] // s, canvas[1] // s, c)).astype(np.float32)
            for s in (4, 8, 16, 32)]


def fixture(name):
    """(maps, boxes) as numpy, after tests/test_pallas_roi_align.py."""
    if name == "random":
        rng = np.random.default_rng(0)
        maps = make_maps(rng, 2, (256, 384), 8)
        xy = rng.uniform(0, 200, (2, 6, 2))
        wh = rng.uniform(8, 150, (2, 6, 2))
        return maps, np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if name == "edge":
        return make_maps(0, 2, (256, 384), 8), np.asarray([EDGE] * 2, np.float32)
    if name == "extreme":
        return make_maps(3, 2, (256, 384), 8), np.asarray([EXTREME] * 2, np.float32)
    if name == "overflow":
        return make_maps(7, 1, (832, 1344), 8), np.asarray([OVERFLOW], np.float32)
    raise KeyError(name)


def port(maps, boxes):
    return multiscale_roi_align([torch.from_numpy(m) for m in maps], torch.from_numpy(boxes)).numpy()


@pytest.mark.parametrize("name", ["random", "edge", "extreme", "overflow"])
def test_matches_jax_gather(name):
    maps, boxes = fixture(name)
    want = jax.vmap(lambda *a: jax_gather(a[:-1], a[-1]))(*map(jnp.asarray, maps), jnp.asarray(boxes))
    np.testing.assert_allclose(port(maps, boxes), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["random", "edge", "extreme", "overflow"])
def test_matches_pallas_exact(name):
    maps, boxes = fixture(name)
    want = roi_align_exact(tuple(map(jnp.asarray, maps)), jnp.asarray(boxes), interpret=True)
    np.testing.assert_allclose(port(maps, boxes), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["random", "edge"])
def test_matches_pallas_kernel(name):
    # Boxes inside the TPU window: the raw Pallas kernel alone is exact there.
    maps, boxes = fixture(name)
    want = pallas_multiscale_roi_align(tuple(map(jnp.asarray, maps)), jnp.asarray(boxes),
                                       interpret=True)
    np.testing.assert_allclose(port(maps, boxes), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_level_assignment_matches():
    rng = np.random.default_rng(1)
    side = np.exp(rng.uniform(np.log(1), np.log(1400), (200, 2)))
    boxes = np.concatenate([np.zeros((200, 2)), side], -1).astype(np.float32)
    boxes = np.concatenate([boxes, [[0, 0, 112, 112], [0, 0, 224, 224], [0, 0, 448, 448],
                                    [0, 0, 0, 0], [5, 5, 1, 1]]]).astype(np.float32)
    got = fpn_level_assignment(torch.from_numpy(boxes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_levels(jnp.asarray(boxes))))


def test_auto_dispatch_cpu_and_kernel_refuses_cpu():
    maps, boxes = fixture("edge")
    tm, tb = [torch.from_numpy(m) for m in maps], torch.from_numpy(boxes)
    before = roi_align_cuda.launches
    np.testing.assert_array_equal(roi_align_auto(tm, tb).numpy(), port(maps, boxes))
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_cuda(tm, tb)
    assert roi_align_cuda.launches == before

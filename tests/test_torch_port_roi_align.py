"""The port's plain multi-scale RoIAlign vs the JAX package's three forms.

The gather reference ``multiscale_roi_align``, the exact Pallas path
``roi_align_exact`` and the raw kernel ``pallas_multiscale_roi_align`` (both
in Pallas interpret mode) on the fixtures of ``test_pallas_roi_align.py``,
including the 832x1344 window-overflow boxes; rtol/atol 1e-4.  The CUDA
kernel itself is held against this plain version on the card by
``chip_smoke.py``; here, its wrapper's refusals, the box cases that
``chip_smoke.py`` builds for it and the bounds it times the kernels against.
"""

import types

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoibench.roofline import adjoint_ops, roi_forward_bound_s
from skghoi_tpu.ops.pallas_roi_align import pallas_multiscale_roi_align, roi_align_exact
from skghoi_tpu.ops.roi_align import fpn_level_assignment as jax_levels
from skghoi_tpu.ops.roi_align import multiscale_roi_align as jax_gather
from skghoi_torch.entry import make_batch
from skghoi_torch.models.interaction_head import filter_detections
from skghoi_torch.ops import roi_align as plain
from skghoi_torch.ops import roi_align_cuda as roi_align_cuda_module
from skghoi_torch.ops.roi_align import fpn_level_assignment, multiscale_roi_align
from skghoi_torch.ops.roi_align_cuda import (ENTRY_POINTS, RoIAlignKernel, roi_align_auto,
                                             roi_align_cuda)

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


def _bad_inputs(kind):
    rng = np.random.default_rng(5)
    c = 12 if kind == "channels_not_multiple_of_8" else 16
    maps = [torch.from_numpy(m) for m in make_maps(rng, 2, (64, 96), c)]
    boxes = torch.tensor([[[4.0, 4.0, 40.0, 30.0]]] * 2)
    if kind == "mixed_dtypes":
        maps[2] = maps[2].to(torch.bfloat16)
    if kind == "non_contiguous":
        maps[1] = maps[1].permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    return maps, boxes


@pytest.mark.parametrize("kind, match", [("channels_not_multiple_of_8", "multiple of 8"),
                                         ("mixed_dtypes", "dtype"),
                                         ("non_contiguous", "contiguous")])
def test_kernel_refuses_before_building(kind, match, tmp_path):
    maps, boxes = _bad_inputs(kind)
    kernel = RoIAlignKernel(build_dir=tmp_path)
    for call in (lambda: kernel(maps, boxes),
                 lambda: kernel.launch(maps, boxes, fpn_level_assignment(boxes),
                                       torch.empty(2, 1, 7, 7, maps[0].shape[-1]))):
        with pytest.raises(ValueError, match=match):
            call()
    assert kernel.launches == 0 and kernel._lib is None and not any(tmp_path.iterdir())


def test_kernel_build_raises_on_a_missing_entry_point(monkeypatch, tmp_path):
    # A library without one of the four entry points is refused when it loads,
    # not on the first launch that would need it.
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in ENTRY_POINTS
                                   if name != "skghoi_roi_align_bwd_bf16"})
    monkeypatch.setattr(roi_align_cuda_module, "build_library", lambda *args: (lib, ""))
    kernel = RoIAlignKernel(build_dir=tmp_path)
    with pytest.raises(AttributeError, match="skghoi_roi_align_bwd_bf16"):
        kernel.build()
    assert kernel._lib is None


def test_plain_division_matches_python_number_on_cpu(monkeypatch):
    # The plain version divides by a float32 tensor on the input's device (so
    # that CUDA divides instead of multiplying by the reciprocal); on the CPU
    # that is bit-for-bit the division by the Python number.
    maps, boxes = fixture("overflow")
    boxes = np.concatenate([boxes, np.asarray([EXTREME[:4]], np.float32)], 1)
    got = port(maps, boxes)
    got_levels = fpn_level_assignment(torch.from_numpy(boxes)).numpy()
    monkeypatch.setattr(plain, "_div", lambda x, d: x / d)
    np.testing.assert_array_equal(got, port(maps, boxes))
    np.testing.assert_array_equal(got_levels, fpn_level_assignment(torch.from_numpy(boxes)).numpy())


def test_chip_smoke_grid28_boxes_reach_the_largest_grid():
    hw = [(chip_smoke.CANVAS[0] // s, chip_smoke.CANVAS[1] // s) for s in (4, 8, 16, 32)]
    got = torch.stack(chip_smoke.grid_shapes(torch.tensor(chip_smoke.GRID28_BOXES), hw), -1)
    assert [tuple(r) for r in got.tolist()] == chip_smoke.GRID28_SHAPES
    # No box of any level has more distinct rows or columns than 2 x 14 samples.
    rng = np.random.default_rng(2)
    xy = rng.uniform(-100, 1400, (500, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(0, 1200, (500, 2))], -1)
                             .astype(np.float32))
    _, rows, cols = chip_smoke.grid_shapes(boxes, hw)
    assert int(rows.max()) <= 28 and int(cols.max()) <= 28


# The main path's boxes (phase 2: ``make_batch(BATCH, CANVAS)`` through
# ``filter_detections``, bf16 maps at C=256): the forward's bound, its distinct
# cells and the adjoint's bytes and multiply-adds, as ``chip_smoke.py`` counted
# them itself before it read ``hoibench.roofline``.
MAIN_FWD_BOUND_MS = 0.007352988656716418
MAIN_FWD_CELLS = 36341
MAIN_ADJ_BYTES = 386_216_640
MAIN_ADJ_BYTES_MS = 0.11528854925373135
MAIN_ADJ_OPS = 47_149_568


@pytest.mark.parametrize("direction", ["forward", "adjoint"])
def test_chip_smoke_bounds_at_the_main_path(direction):
    b = make_batch(chip_smoke.BATCH, chip_smoke.CANVAS, device="cpu")
    boxes = filter_detections(b.det_boxes, b.det_labels, b.det_scores, b.det_valid).boxes
    bsz, n = boxes.shape[:2]
    shapes = [(bsz, chip_smoke.CANVAS[0] // s, chip_smoke.CANVAS[1] // s, 256)
              for s in (4, 8, 16, 32)]
    if direction == "forward":
        got = roi_forward_bound_s(shapes, boxes, 2, chip_smoke.HBM_BYTES_PER_S,
                                  chip_smoke.FP32_FLOPS_PER_S) * 1e3
        cell_bytes = MAIN_FWD_CELLS * 256 * 2 + bsz * n * (49 * 256 * 2 + 16 + 4)
        assert got == MAIN_FWD_BOUND_MS == cell_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    else:
        bytes_ms, _, n_bytes, _ = chip_smoke.adjoint_bounds(shapes, n, 2)
        assert (n_bytes, bytes_ms) == (MAIN_ADJ_BYTES, MAIN_ADJ_BYTES_MS)
        assert adjoint_ops(shapes, boxes) == MAIN_ADJ_OPS


def test_chip_smoke_map_edge_boxes_cover_every_edge_and_level():
    boxes = np.asarray(chip_smoke.MAP_EDGE_BOXES, np.float32)
    h, w = chip_smoke.CANVAS
    assert (boxes[:, 0] <= 0).any() and (boxes[:, 1] <= 0).any()
    assert (boxes[:, 2] >= w).any() and (boxes[:, 3] >= h).any()
    levels = fpn_level_assignment(torch.from_numpy(boxes))
    assert sorted(set(levels.tolist())) == [0, 1, 2, 3]


def test_chip_smoke_kernel_cases_shapes():
    main = torch.from_numpy(np.asarray([EDGE * 5] * chip_smoke.BATCH, np.float32))
    cases = chip_smoke.kernel_cases(main)
    assert [name for name, _, _ in cases] == ["main", "edge", "grid28", "map_edges", "padding",
                                              "b1n1", "many"]
    for name, bsz, boxes in cases:
        assert boxes.shape[0] == bsz and boxes.shape[-1] == 4 and boxes.is_contiguous(), name
    assert not cases[4][2].any() and cases[5][2].shape == (1, 1, 4)
    # "many": more items than the kernel plans for (kMaxOrdered, roi_align.cu) at every C
    assert cases[6][2].shape == (chip_smoke.BATCH, chip_smoke.MANY_BOXES, 4)
    assert chip_smoke.BATCH * chip_smoke.MANY_BOXES > 4096


def _kernel_ranks(lo, hi):
    """The kernel's indices of each sample's low and high cell in the sorted
    distinct list, and that list, by its rule: drop samples whose low cell
    repeats the previous one's; of the rest, a cell is new where it exceeds
    the cell before it in lo0, hi0, lo1, hi1, ...; a repeated sample takes the
    indices of the first sample of its run."""
    cells, r_lo, r_hi = [], [], []
    for s in range(len(lo)):
        if s > 0 and lo[s] == lo[s - 1]:
            r_lo.append(r_lo[-1])
            r_hi.append(r_hi[-1])
            continue
        if s == 0 or lo[s] > hi[s - 1]:
            cells.append(lo[s])
        r_lo.append(len(cells) - 1)
        if hi[s] > lo[s]:
            cells.append(hi[s])
        r_hi.append(len(cells) - 1)
    return np.asarray(cells), np.asarray(r_lo), np.asarray(r_hi)


def _merged_weights_roi_align(maps, boxes):
    """The CUDA kernel's arithmetic in numpy: per box, the sorted distinct rows
    and columns its samples read, each output row's and column's bin (the
    distinct cells of its two samples, summed weights), and the output as the
    weighted sum over bin x bin.  Checks the kernel's invariants on the way."""
    boxes_t = torch.from_numpy(boxes)
    levels = fpn_level_assignment(boxes_t).numpy()
    c = maps[0].shape[-1]
    out = np.zeros(boxes.shape[:2] + (7, 7, c), np.float32)
    for (b, n), l in np.ndenumerate(levels):
        fm, stride = maps[l][b], (4, 8, 16, 32)[l]
        bins = []
        for axis, size in ((1, fm.shape[0]), (0, fm.shape[1])):
            start = boxes_t[b:b + 1, n:n + 1, axis] * (1.0 / stride)
            length = (boxes_t[b:b + 1, n:n + 1, axis + 2] * (1.0 / stride) - start).clamp_min(1.0)
            lo, hi, w_lo, w_hi, oob = (t.reshape(-1).numpy() for t in
                                       plain._sample_axis(start, length, size, 7, 2))
            w_lo, w_hi = np.where(oob, 0, w_lo), np.where(oob, 0, w_hi)  # as the kernel does
            cells = np.unique(np.concatenate([lo, hi]))
            assert len(cells) <= 28
            rlo, rhi = np.searchsorted(cells, lo), np.searchsorted(cells, hi)
            k_cells, k_lo, k_hi = _kernel_ranks(lo, hi)
            np.testing.assert_array_equal(k_cells, cells)
            np.testing.assert_array_equal(k_lo, rlo)
            np.testing.assert_array_equal(k_hi, rhi)
            axis_bins = []
            for k in range(7):
                s0, s1 = 2 * k, 2 * k + 1
                first, count = rlo[s0], rhi[s1] - rlo[s0] + 1
                assert count <= 4 and set(range(first, first + count)) == {
                    rlo[s0], rhi[s0], rlo[s1], rhi[s1]}
                w = np.zeros(count, np.float32)
                for r, wt in ((rlo[s0], w_lo[s0]), (rhi[s0], w_hi[s0]),
                              (rlo[s1], w_lo[s1]), (rhi[s1], w_hi[s1])):
                    w[r - first] += wt
                axis_bins.append((cells[first:first + count], w))
            bins.append(axis_bins)
        for py, (ys, wy) in enumerate(bins[0]):
            for px, (xs, wx) in enumerate(bins[1]):
                out[b, n, py, px] = np.einsum("i,k,ikc->c", wy * 0.25, wx, fm[ys][:, xs])
    return out


@pytest.mark.parametrize("name", ["random", "edge", "extreme", "overflow"])
def test_kernel_merged_weights_match_plain(name):
    maps, boxes = fixture(name)
    np.testing.assert_allclose(_merged_weights_roi_align(maps, boxes), port(maps, boxes),
                               rtol=1e-5, atol=1e-5)


def test_kernel_merged_weights_grid28_map_edges_and_random():
    rng = np.random.default_rng(11)
    maps = make_maps(rng, 1, chip_smoke.CANVAS, 8)
    xy = rng.uniform(-60, 1400, (40, 2))
    rand = np.concatenate([xy, xy + np.exp(rng.uniform(0, 7, (40, 2)))], -1).tolist()
    boxes = np.asarray([chip_smoke.GRID28_BOXES + chip_smoke.MAP_EDGE_BOXES + rand], np.float32)
    np.testing.assert_allclose(_merged_weights_roi_align(maps, boxes), port(maps, boxes),
                               rtol=1e-5, atol=1e-5)


def _kernel_classes(boxes, levels, strides=(4, 8, 16, 32)):
    """The kernel's work_class: estimated distinct cells in quarters of 28 x 28."""
    w = np.clip((boxes[:, 2] - boxes[:, 0]) / np.take(strides, levels) + 2, 1, 28)
    h = np.clip((boxes[:, 3] - boxes[:, 1]) / np.take(strides, levels) + 2, 1, 28)
    return np.minimum(3, (w * h * (4.0 / 785.0)).astype(np.int32))


def _kernel_items(item_class, grid):
    """The items each CTA takes (plan_items, later_item): CTA k first item k;
    then, by its rank among the first round (class, largest first, then
    position), items of the rest in the same order, dealt back and forth."""
    n_items = len(item_class)
    key = lambda p: (-item_class[p], p)  # noqa: E731
    rank = {p: r for r, p in enumerate(sorted(range(grid), key=key))}
    rest = sorted(range(grid, n_items), key=key)
    dealt = {}
    for k in range(grid):
        items, j = [k], 1
        while True:
            q = (j - 1) * grid + (grid - 1 - rank[k] if j % 2 else rank[k])
            if q >= len(rest):
                break
            items.append(rest[q])
            j += 1
        dealt[k] = items
    return dealt


@pytest.mark.parametrize("grid, n_items", [(1, 7), (5, 5), (5, 6), (5, 9), (5, 10), (5, 23),
                                           (264, 264), (264, 480), (264, 1000)])
def test_kernel_deals_every_item_once(grid, n_items):
    rng = np.random.default_rng(grid + n_items)
    xy = rng.uniform(-60, 1300, ((n_items + 1) // 2, 2))
    boxes = np.concatenate([xy, xy + np.exp(rng.uniform(0, 7, xy.shape))], -1).astype(np.float32)
    classes = _kernel_classes(boxes, fpn_level_assignment(torch.from_numpy(boxes)).numpy())
    item_class = np.repeat(classes, 2)[:n_items]  # two channel slices a box
    dealt = _kernel_items(item_class, grid)
    assert sorted(p for items in dealt.values() for p in items) == list(range(n_items))
    if grid < n_items < 2 * grid:  # the largest first items get no second one
        by_rank = sorted(range(grid), key=lambda p: (-item_class[p], p))
        assert all(len(dealt[k]) == 1 for k in by_rank[:2 * grid - n_items])
        assert all(len(dealt[k]) == 2 for k in by_rank[2 * grid - n_items:])

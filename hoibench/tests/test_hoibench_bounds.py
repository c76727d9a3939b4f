"""Known answers of the yardstick's arithmetic: the RoIAlign byte bounds, the
FLOP count, and the idle share of a traced window."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from hoibench import roofline
from hoibench.reference.roi_align import fpn_level
from hoibench.trace import Trace

SHAPES_832 = [(8, 832 // s, 1344 // s, 256) for s in (4, 8, 16, 32)]


def test_adjoint_bytes_at_the_train_step_shape():
    # bf16, 832x1344, batch 8, 30 slots: 386.2 MB (chip_smoke phase 5, PR 12).
    assert roofline.adjoint_bytes(SHAPES_832, 30, 2) == 386_216_640


def test_forward_bound_counts_each_cell_once():
    # One 16x16 box at the origin of P2 (level 0): its 14 samples a side read
    # rows and columns 0..4 (28 low/high cells, 5 distinct), so 25 cells.
    shapes = [(1, 16, 16, 8), (1, 8, 8, 8), (1, 4, 4, 8), (1, 2, 2, 8)]
    boxes = torch.tensor([[[0.0, 0.0, 16.0, 16.0]]])
    assert int(fpn_level(boxes)) == 0
    bound = roofline.roi_forward_bound_s(shapes, boxes, 4, hbm_bytes=1.0, fp32_flops=1e30)
    assert bound == 25 * 8 * 4 + 49 * 8 * 4 + 16 + 4
    twice = torch.cat([boxes, boxes], 1)
    bound2 = roofline.roi_forward_bound_s(shapes, twice, 4, hbm_bytes=1.0, fp32_flops=1e30)
    assert bound2 == 25 * 8 * 4 + 2 * 49 * 8 * 4 + 32 + 8


def test_adjoint_ops_count_nonzero_weight_pairs():
    shapes = [(1, 16, 16, 8), (1, 8, 8, 8), (1, 4, 4, 8), (1, 2, 2, 8)]
    boxes = torch.tensor([[[0.0, 0.0, 16.0, 16.0]]])
    # Each axis: 7 bins of 2 samples at (i + .25, i + .75) * 4/7 cells; count
    # the nonzero (bin, cell) weights by hand from the sample positions.
    pos = [(b + (k + 0.5) / 2) * 4 / 7 for b in range(7) for k in range(2)]
    cells = set()
    for i, p in enumerate(pos):
        lo = int(p)
        cells.add((i // 2, lo))
        if p - lo:
            cells.add((i // 2, lo + 1))
    per_axis = len(cells)
    assert roofline.adjoint_ops(shapes, boxes) == 2 * per_axis * per_axis * 8


def test_flops_of_the_train_step_at_the_cell_shape():
    """The reference's convolutions and products of one train step at
    832x1344, batch 8, on meta tensors (7.06 TFLOP)."""
    import numpy as np

    from hoibench.drivers.scg_train import Driver
    from tiny import tiny_cell

    cell = tiny_cell("scg_r50.train_b8")
    d = Driver(cell, 0, torch.device("cpu"))
    d.ovm_np = np.zeros((80, 117), np.float32)
    d.traffic = dict(d.traffic, batch=8)
    d.pool = [dict(images=np.zeros((8, 832, 1344, 3), np.float32), image_sizes=np.zeros((8, 2), np.float32),
                   original_sizes=np.zeros((8, 2), np.float32),
                   det_boxes=np.zeros((8, 128, 4), np.float32), det_labels=np.zeros((8, 128), np.int32),
                   det_scores=np.zeros((8, 128), np.float32), det_valid=np.zeros((8, 128), bool),
                   gt_boxes_h=np.zeros((8, 32, 4), np.float32), gt_boxes_o=np.zeros((8, 32, 4), np.float32),
                   gt_object=np.zeros((8, 32), np.int32), gt_labels=np.zeros((8, 32), np.int32),
                   gt_valid=np.zeros((8, 32), bool))]
    assert roofline.count_flops(d.flop_fn((832, 1344))) == pytest.approx(7.058570351616e12, rel=1e-9)


def _event(name, start, end, device):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU)


def test_idle_share_is_the_union_of_device_intervals_over_the_window():
    events = [
        _event("hoibench.window", 0.0, 100.0, False),
        _event("hoibench.step", 0.0, 100.0, False),
        _event("aten::conv", 0.0, 30.0, False),
        _event("cudaLaunchKernel", 6.0, 7.0, False),
        _event("cuLaunchKernel", 8.0, 9.0, False),
        _event("kernel_a", 10.0, 30.0, True),
        _event("kernel_b", 20.0, 40.0, True),  # overlaps a
        _event("kernel_c", 70.0, 80.0, True),
        _event("hoibench.step", 10.0, 90.0, True),  # a range's device row: not device work
    ]
    tr = Trace(events)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.launches == 2
    gaps = tr.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 20e-6, 10e-6])
    assert gaps[0][0] == "hoibench.step"
    assert gaps[2][0] == "hoibench.step/aten::conv"
    assert tr.device_ops()[0] == ["kernel_a", pytest.approx(20e-6)]

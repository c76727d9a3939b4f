#!/usr/bin/env python3
"""Drive the PyTorch port of the SCG HOI network on one CUDA card.

    python3 chip_smoke.py [--profile DIR] [--baseline-source OTHER/roi_align.cu]

Phases, each reporting on its own lines; any failure exits non-zero:

1. The card (``nvidia-smi`` name and power limit), and the build of the CUDA
   RoIAlign kernel from ``skghoi_torch/csrc`` into ``skghoi_torch/_build``.
2. The kernel against its plain PyTorch version on the card, in float32 and
   bfloat16, over the 832x1344 FPN pyramid at C=256 (the main path's), 136
   (a ragged last channel slice) and 64, batch 8: the 30 filtered box slots
   the main path gives it, edge/degenerate/window-overflow boxes, boxes with
   the largest distinct sample grid on each level, boxes on every map edge,
   a batch of padding slots only, B=1, N=1, and 600 random boxes an image
   (more work items than the kernel plans an order for); and on the portrait
   1344x832 pyramid (C=256, batch 8), where portrait images go, the main
   path's boxes and the map-edge boxes transposed.  Then timed with
   CUDA events on the main path's inputs: the kernel alone with a cold L2
   (successive calls rotate over copies of the pyramid), the same warm, on
   padding slots only, the call with its level assignment, the eager call
   and the plain version (``--baseline-source`` times another build of the
   kernel alone beside this one).
3. The float32 network on the card against the same network on the CPU
   (64x96, batch 2; TF32 off): scores within 1e-4, filtered boxes and counts
   equal.
4. The main path: the bfloat16 network at full width, 832x1344, batch 8,
   answering ``REQUESTS`` forward requests with the launch counts set to 0
   just before; it checks the scores, that the kernel ran once per request,
   prints img/s, and holds the scores against the float32 network's.
5. The RoIAlign gradient: ``RoIAlignFunction`` (the kernel forward, the
   adjoint GEMMs backward) against autograd through the plain gather
   version, on the card, with respect to all four maps of the 832x1344
   pyramid (C=256, batch 8) for the main path's boxes, the edge/overflow
   boxes and the map-edge boxes: float32 within rtol 1e-3 / atol 1e-4 (the
   JAX suite's tolerance for this gradient); bfloat16 maps and cotangent
   against the float32 reference within ``2^-8 * (|ref| + A|g|)`` per
   element, where ``A|g|`` is the adjoint of the cotangent's magnitude (the
   cotangent's rounding, 2^-9 relative, plus the result's, with a factor 2
   to spare).  Then the adjoint alone on the main path's inputs (bf16): its
   eager time and its device time (CUDA events, the call queued behind a
   device sleep), beside its byte bound and its GEMM-operation bound, and
   the launches one call issues (torch.profiler's host-side launch calls).
6. The float32 train step on the card against the same step on the CPU
   (64x96, batch 2; TF32 off; the same seeded weights, batch and Gumbel
   noise): the three losses within rtol 1e-5, every gradient within
   ``1e-3 * max|g|`` of the CPU's (the adjacency bias, whose exact
   gradient is 0, at the adjacency weight's scale).
7. The training main path: ``entry.train_entry()``, the bfloat16 SCG at full
   width, 832x1344, batch 8, ``frozen_stages=1``, three losses, two-group
   AdamW at the reference lr; one warm-up step, then ``TRAIN_STEPS`` timed
   steps with the counts set to 0 just before.  It checks that every loss
   is finite and every step applied, that the kernel and its adjoint ran
   once per step, that the stem and ``layer1`` are bit-for-bit unchanged and
   that both optimizer groups moved; prints per-step ms, train img/s, peak
   memory, the losses, and what the NaN guard's host read costs.
   ``--profile`` adds one traced train step (device busy and idle share, top
   operations).
8. The CLI path: synthetic HICO-DET written by ``data.synthetic`` (16
   landscape training images at 480x640, resized to 800x1066 in the 832x1344
   canvas; 8 portrait test images at 640x480), then
   ``tools.train_hicodet.main`` at full width in float32 (TF32 off), batch
   8, 2 epochs with validation on the portrait split, 4 loader workers, with
   the counts set to 0 just before: it checks two ``Epoch:`` lines, finite
   losses, ``ckpt_01.pt`` and ``ckpt_02.pt``, one kernel launch per train
   step and per validation batch and one adjoint per train step; resumes
   from ``ckpt_01.pt`` (epoch, applied steps, lr, parameters and AdamW
   moments equal to the file) and traces one more epoch (the device's idle
   share); runs ``tools.test_hicodet.main`` with ``ckpt_02.pt`` (full, rare
   and non-rare mAP finite, in [0, 1]); holds ``device_resize_canvas`` on the
   card against itself on the CPU (atol 1e-6) and against the host
   ``prepare_image`` on these images (atol 2e-5 plus the float32 resize
   ratio's position error, ``(h + w) * 2^-24``); times the host stages of a
   batch (decode, resize, collate, pinned copy); and trains one
   ``--device-resize`` epoch.  Prints loader-inclusive train img/s, eval
   img/s, idle share, peak memory and the launch counts.

9. The KGE toolkit, on seeded synthetic KGs written by
   :func:`write_synthetic_kg` at FB15K237's published sizes (14 541
   entities, 237 relations, 272 115 / 17 535 / 20 466 triples) and WN18RR's
   (40 943, 11, 86 835 / 3 034 / 3 134), Zipf-like degrees, with type
   constraints: (a) for ``transe_fb15k237``, ``transh_fb15k237`` and
   ``transe_wn18rr`` (one-side, sigmoid-adversarial, Adam, dim 1024), three
   trainer steps on the card and on the CPU from the same seeded state on
   the same batches, in float64 (parameters within 1e-5 of each tensor's
   max) and in float32 (the same but in at most 2 rows a step of each table,
   where an L1 component rounds to opposite signs), then the raw and
   filtered ranks of the first 512 test triples, under the same tables,
   equal on both (a rank may differ only at a float tie within 2^-20 of the
   row's scale, by at most the tied entities; such ranks are counted);
   (b) ``tools.train_kge.main`` at ``--example transe_fb15k237`` and
   ``transh_fb15k237`` for 5 epochs (the logged loss must fall), filtered
   link prediction over all test triples, the ``--checkpoint`` reloaded
   with ``--epochs 0`` reprinting the same metrics, and one
   ``--type-constrain`` evaluation; (c) ``--example
   transe_wn18rr`` for 2 epochs on the WN18RR-size KG.  For each preset:
   epoch ms (median of 3, after a warm-up epoch), train triples/s with
   negatives, one traced epoch's device busy time and idle share, and the
   step's byte bound.
10. ``cache_results --dataset vcoco`` (float32, 832x1344, batch 8) on
    synthetic V-COCO (8 images 480x640), then ``vcoco_evaluation`` on the
    pickle, its mean role AP equal to a run of the same pickle in a process
    with no card; ``pretrain_transh_hoi --synthetic`` on the card, then
    ``train_hicodet --synthetic --transh-init`` (the SCG's TransH tables
    equal the checkpoint's after loading; one epoch, counting the kernel's
    launches as ``launches_cli_transh``).

It prints the adjoint's, the train step's, the CLI path's, the KGE and the
V-COCO/TransH JSON lines, the kernels' JSON line, the card, then
``{"ok": true, "device": ...}`` last.  Without a CUDA device it exits with
code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12   # H100 SXM, outside the tensor cores
FP32_TOL = 1e-5  # kernel vs plain, float32: 20x the largest error measured (PERF.md)
CANVAS = (832, 1344)
PORTRAIT = (1344, 832)
BATCH = 8
REQUESTS = 5  # main-path forward requests (the contract asks for at least 3)
TRAIN_STEPS = 5  # timed train steps of the training main path
ADJOINT_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_pallas_roi_align.py:106-129
PARITY_SEED = 0  # weights of the train-step parity phase
CLI_TRAIN_IMAGES = 16  # phase 8: landscape training images (2 steps an epoch)
CLI_TEST_IMAGES = 8    # phase 8: portrait validation / test images (1 batch)

EDGE_BOXES = [  # tests/test_pallas_roi_align.py: edge, extreme and overflow fixtures
    [0.0, 0.0, 383.0, 255.0], [-20.0, -20.0, 30.0, 30.0], [370.0, 240.0, 383.0, 255.0],
    [5.0, 5.0, 6.0, 6.0], [0.0, 0.0, 0.0, 0.0], [100.0, 50.0, 220.0, 200.0],
    [0.0, 100.0, 380.0, 112.0], [200.0, 0.0, 214.0, 250.0], [0.0, 0.0, 383.0, 30.0],
    [-10.0, -10.0, 390.0, 260.0], [50.0, 50.0, 51.0, 51.0],
    [100.0, 300.0, 1000.0, 400.0], [40.0, 700.0, 1340.0, 760.0], [200.0, 200.0, 400.0, 500.0],
    [0.0, 0.0, 1344.0, 832.0], [-50.0, -40.0, 1400.0, 900.0],
]
# The largest distinct sample grid a box can reach on each level (27 cells a
# side): 28x28 cells on P2, P3 and P4; 26x28 on P5, whose map has 26 rows.
GRID28_BOXES = [[20.0, 12.0, 128.0, 120.0], [40.0, 24.0, 256.0, 240.0],
                [80.0, 48.0, 512.0, 480.0], [160.0, 0.0, 1024.0, 864.0]]
GRID28_SHAPES = [(0, 28, 28), (1, 28, 28), (2, 28, 28), (3, 26, 28)]  # (level, rows, columns)
MANY_BOXES = 600  # slots an image in the "many" case: more items than the kernel plans for
MAP_EDGE_BOXES = [  # each edge of the 832x1344 canvas, on every level
    [0.0, 300.0, 60.0, 360.0], [1284.0, 300.0, 1344.0, 360.0],    # P2 left, right
    [600.0, 0.0, 660.0, 60.0], [600.0, 772.0, 660.0, 832.0],      # P2 top, bottom
    [0.0, 0.0, 150.0, 150.0], [1194.0, 682.0, 1344.0, 832.0],     # P3 corners
    [0.0, 500.0, 300.0, 832.0], [1044.0, 0.0, 1344.0, 300.0],     # P4 corners
    [672.0, 0.0, 1344.0, 832.0], [0.0, 0.0, 700.0, 832.0],        # P5 halves
    [1300.0, 790.0, 1360.0, 850.0], [-30.0, -30.0, 20.0, 20.0],   # across the corners
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Per-call time of ``fn`` issued eagerly, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Host calls that put work on the device, as torch.profiler names them.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemsetAsync", "cudaMemcpyAsync")


def queued_ms(fn, reps: int) -> float:
    """Median device time of ``fn``: each call is queued behind a ~20 ms
    device sleep, so the host has issued all of it before the device starts
    and the events measure the device alone (``fn`` must not synchronise)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(40_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def graph_ms(calls, iters: int) -> float:
    """Device time per call of ``calls``: all of them, in order, captured in
    one CUDA graph and replayed, so host launch cost is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:  # warm-up off the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    return cuda_ms(graph.replay, iters) / len(calls)


def sample_cells(boxes, hw):
    """FPN level of each box of ``[..., 4]`` ``boxes``, and for each level the
    map rows and columns its 14 samples a side read there (low and high cell,
    ``[..., 28]`` each), over maps of sizes ``hw`` (four (H, W), finest first)."""
    from skghoi_torch.ops.roi_align import _sample_axis, fpn_level_assignment

    per_level = []
    for (h, w), stride in zip(hw, (4, 8, 16, 32)):
        x1, y1 = boxes[..., 0] / stride, boxes[..., 1] / stride
        roi_w = (boxes[..., 2] / stride - x1).clamp_min(1.0)
        roi_h = (boxes[..., 3] / stride - y1).clamp_min(1.0)
        yl, yh, *_ = _sample_axis(y1, roi_h, h, 7, 2)
        xl, xh, *_ = _sample_axis(x1, roi_w, w, 7, 2)
        per_level.append((torch.cat([yl, yh], -1), torch.cat([xl, xh], -1)))
    return fpn_level_assignment(boxes), per_level


def grid_shapes(boxes, hw):
    """Level, distinct sample rows and distinct sample columns of each box."""
    levels, per_level = sample_cells(boxes, hw)
    rows, cols = torch.zeros_like(levels), torch.zeros_like(levels)
    for l, cells in enumerate(per_level):
        for dst, idx in zip((rows, cols), cells):
            srt = idx.sort(-1).values
            n = 1 + (srt[..., 1:] != srt[..., :-1]).sum(-1)
            dst.copy_(torch.where(levels == l, n.to(dst.dtype), dst))
    return levels, rows, cols


def roi_bound_ms(maps, boxes):
    """Least time for the kernel's work on these inputs: the larger of its
    bytes (distinct map cells the samples read, the boxes, levels and the
    output) over HBM bandwidth and its float32 operations over peak."""
    bsz, n = boxes.shape[:2]
    c, elem = maps[0].shape[-1], maps[0].element_size()
    levels, per_level = sample_cells(boxes, [fm.shape[1:3] for fm in maps])
    cells, base = [], 0
    for l, (fm, (ys, xs)) in enumerate(zip(maps, per_level)):
        h, w = fm.shape[1:3]
        img = torch.arange(bsz, device=boxes.device)[:, None, None, None]
        ids = base + (img * h + ys[..., :, None]) * w + xs[..., None, :]
        cells.append(ids[levels == l].flatten())
        base += bsz * h * w
    touched = torch.unique(torch.cat(cells)).numel()
    out_bytes = bsz * n * 49 * c * elem
    n_bytes = touched * c * elem + out_bytes + boxes.numel() * 4 + levels.numel() * 4
    flops = bsz * n * 49 * c * (4 * 4 * 2 + 2)  # 4 samples x 4 corners, mean
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), touched


def kernel_cases(main_boxes):
    """(name, batch size, [B, N, 4] boxes) held against the plain version."""
    dev = main_boxes.device

    def tile(boxes):
        return torch.tensor([boxes] * BATCH, device=dev)

    grid = tile(GRID28_BOXES)
    got = tuple(torch.stack(grid_shapes(grid[0], [(CANVAS[0] // s, CANVAS[1] // s)
                                                  for s in (4, 8, 16, 32)]), -1).tolist())
    if got != tuple(map(list, GRID28_SHAPES)):
        raise AssertionError(f"GRID28_BOXES give (level, rows, cols) {got}")
    g = torch.Generator(device=dev).manual_seed(1)
    xy = torch.rand(BATCH, MANY_BOXES, 2, generator=g, device=dev) * 1400.0 - 40.0
    wh = torch.exp(torch.rand(BATCH, MANY_BOXES, 2, generator=g, device=dev) * 7.0)
    many = torch.cat([xy, xy + wh], -1)
    return [("main", BATCH, main_boxes), ("edge", BATCH, tile(EDGE_BOXES)),
            ("grid28", BATCH, grid), ("map_edges", BATCH, tile(MAP_EDGE_BOXES)),
            ("padding", BATCH, torch.zeros_like(main_boxes)),
            ("b1n1", 1, main_boxes[:1, :1].contiguous()), ("many", BATCH, many)]


def check_kernel(main_boxes):
    """The kernel against the plain version on every case, for float32 and
    bfloat16, at C=256 (the main path's), 136 (a ragged last slice) and 64;
    returns the largest error per dtype on the main path's inputs."""
    from skghoi_torch.ops.roi_align import multiscale_roi_align
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda

    cases = kernel_cases(main_boxes)
    errs = {}
    for c in (256, 136, 64):
        g = torch.Generator(device="cuda").manual_seed(c)
        maps32 = [torch.randn(BATCH, CANVAS[0] // s, CANVAS[1] // s, c, device="cuda", generator=g)
                  for s in (4, 8, 16, 32)]
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, 1e-2)):
            full = [m.to(dtype) for m in maps32]
            for name, bsz, boxes in cases:
                maps = full if bsz == BATCH else [m[:bsz].contiguous() for m in full]
                got = roi_align_cuda(maps, boxes)
                want = multiscale_roi_align(maps, boxes)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != want.shape:
                    raise AssertionError(f"kernel output {got.dtype} {tuple(got.shape)}")
                err = (got.float() - want.float()).abs().max().item()
                errs[(dtype, c, name)] = err
                ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
                log(f"[kernel] roi_align {str(dtype)[6:]} C={c} {name} boxes {tuple(boxes.shape)}: "
                    f"max|kernel-plain| {err:.3e} (rtol=atol={tol:g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"roi_align kernel disagrees with plain version "
                                         f"({dtype}, C={c}, {name})")
            del full
    errs.update(check_kernel_portrait(main_boxes))
    fp32 = max(v for (d, _, _), v in errs.items() if d == torch.float32)
    log(f"[kernel] roi_align: all {len(errs)} cases agree; largest fp32 error {fp32:.3e}")
    return errs[(torch.bfloat16, 256, "main")], fp32


def check_kernel_portrait(main_boxes):
    """The kernel against the plain version on the portrait 1344x832 pyramid
    (C=256, batch 8), where portrait images go (validation and test batches,
    and training batches of portrait images): the main path's boxes and the
    map-edge boxes, both transposed into that canvas."""
    from skghoi_torch.ops.roi_align import multiscale_roi_align
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda

    swap = [1, 0, 3, 2]
    cases = [("main_portrait", main_boxes[..., swap].contiguous()),
             ("map_edges_portrait",
              torch.tensor([MAP_EDGE_BOXES] * BATCH, device="cuda")[..., swap].contiguous())]
    g = torch.Generator(device="cuda").manual_seed(2)
    maps32 = [torch.randn(BATCH, PORTRAIT[0] // s, PORTRAIT[1] // s, 256, device="cuda",
                          generator=g) for s in (4, 8, 16, 32)]
    errs = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, 1e-2)):
        maps = [m.to(dtype) for m in maps32]
        for name, boxes in cases:
            got = roi_align_cuda(maps, boxes)
            want = multiscale_roi_align(maps, boxes)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            errs[(dtype, 256, name)] = err
            ok = (got.dtype == dtype and got.shape == want.shape
                  and torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
            log(f"[kernel] roi_align {str(dtype)[6:]} C=256 {PORTRAIT[0]}x{PORTRAIT[1]} {name} "
                f"boxes {tuple(boxes.shape)}: max|kernel-plain| {err:.3e} (rtol=atol={tol:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"roi_align kernel disagrees with plain version "
                                     f"({dtype}, {name})")
    return errs


def time_kernel(main_boxes, baseline=None):
    """Times on the main path's inputs (bf16, C=256, 832x1344, batch 8).
    ``baseline``, another build of the kernel's C interface, is timed alone
    beside this one, in turns: baseline, kernel, kernel, baseline."""
    from skghoi_torch.ops.roi_align import fpn_level_assignment, multiscale_roi_align
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda

    g = torch.Generator(device="cuda").manual_seed(0)
    maps = [torch.randn(BATCH, CANVAS[0] // s, CANVAS[1] // s, 256, device="cuda", generator=g)
            .to(torch.bfloat16) for s in (4, 8, 16, 32)]
    levels = fpn_level_assignment(main_boxes).contiguous()
    out = torch.empty((*main_boxes.shape[:2], 7, 7, 256), dtype=torch.bfloat16, device="cuda")
    pyramid_mb = sum(m.numel() * m.element_size() for m in maps) / 1e6
    # Cold L2: successive calls read different copies of the pyramid, so no
    # call finds the previous one's cells in the 50 MB L2 (the main path's
    # pyramid is fresh from the backbone, 380 MB).  Six copies check three.
    copies = [maps] + [[m.clone() for m in maps] for _ in range(5)]

    def alone(k):
        """(cold with 3 copies, cold with 6, warm) ms of kernel build ``k`` alone."""
        def call(m):
            return lambda: k.launch(m, main_boxes, levels, out)
        cold = [graph_ms([call(copies[i % n]) for i in range(10 * n)], iters=20) for n in (3, 6)]
        return (*cold, graph_ms([call(maps)] * 20, iters=20))

    # The same number of items, each a 2x2-cell padding slot: the kernel's
    # cost that does not grow with the cells it reads.
    pad = torch.zeros_like(main_boxes)
    pad_levels = fpn_level_assignment(pad).contiguous()
    pad_ms = graph_ms([(lambda m: lambda: roi_align_cuda.launch(m, pad, pad_levels, out))(
        copies[i % 3]) for i in range(30)], iters=20)
    if baseline is None:
        cold_ms, cold6_ms, warm_ms = alone(roi_align_cuda)
    else:
        turns = [baseline, roi_align_cuda, roi_align_cuda, baseline]
        got = [alone(k) for k in turns]
        for k in turns[:2]:
            rs = [tuple(round(x, 5) for x in r) for kk, r in zip(turns, got) if kk is k]
            log(f"[kernel] in turns (baseline, kernel, kernel, baseline), {k.source}: kernel alone, "
                f"(cold 3 copies, cold 6 copies, warm) ms {rs}")
        cold_ms, cold6_ms, warm_ms = got[2]
    del copies
    call_ms = graph_ms([lambda: roi_align_cuda(maps, main_boxes)] * 20, iters=20)
    eager_ms = cuda_ms(lambda: roi_align_cuda(maps, main_boxes), iters=200)
    plain_ms = cuda_ms(lambda: multiscale_roi_align(maps, main_boxes), iters=10)
    bound_ms, bound_by, touched = roi_bound_ms(maps, main_boxes)
    log(f"[kernel] roi_align bf16 B={BATCH} N={main_boxes.shape[1]} C=256, pyramid "
        f"{pyramid_mb:.1f} MB: kernel alone, cold L2 {cold_ms:.5f} ms (3 pyramid copies; "
        f"{cold6_ms:.5f} with 6), warm L2 {warm_ms:.5f} ms (same inputs), both CUDA graph; "
        f"padding slots only {pad_ms:.5f} ms (cold); "
        f"per call with level assignment {call_ms:.5f} ms (CUDA graph, warm); "
        f"eager call {eager_ms:.5f} ms; plain {plain_ms:.4f} ms; bound {bound_ms:.5f} ms by "
        f"{bound_by} ({touched} distinct cells read): cold time at {bound_ms / cold_ms:.1%} "
        f"of the bound")
    return dict(ms=cold_ms, cold_ms=cold_ms, cold6_ms=cold6_ms, warm_ms=warm_ms, pad_ms=pad_ms,
                call_ms=call_ms,
                eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / cold_ms, library_ms=None)


def phase_kernel(main_boxes, baseline=None):
    err_bf16, err_fp32 = check_kernel(main_boxes)
    return dict(name="roi_align", route="cuda", source="skghoi_torch/csrc/roi_align.cu",
                replaces="skghoi_tpu/ops/pallas_roi_align.py:213",
                max_abs_err=err_bf16, max_abs_err_fp32=err_fp32, **time_kernel(main_boxes, baseline))


def phase_parity():
    from skghoi_torch.entry import build_model, make_batch, verb_mask

    outs = {}
    for dev in ("cpu", "cuda"):
        model = build_model(dtype=torch.float32, device=dev)
        with torch.no_grad():
            outs[dev] = model(make_batch(2, (64, 96), device=dev), verb_mask(device=dev))
    cpu, gpu = outs["cpu"], outs["cuda"]
    err = (gpu.scores.cpu() - cpu.scores).abs().max().item()
    log(f"[parity] fp32 cuda vs cpu, 64x96 batch 2: max|d scores| {err:.3e} (atol 1e-4), "
        f"n_h {cpu.n_h.tolist()} n {cpu.n.tolist()}")
    for name in ("boxes", "n_h", "n", "object_class"):
        if not torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"parity: {name} differ between cuda and cpu")
    if not (cpu.scores > 0).any() or not torch.allclose(gpu.scores.cpu(), cpu.scores, rtol=0, atol=1e-4):
        raise AssertionError("parity: scores differ between cuda and cpu")


def phase_main(requests: int, profile_dir):
    from skghoi_torch.entry import build_model, make_batch, verb_mask
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda

    batch = make_batch(BATCH, CANVAS, device="cuda")
    ovm = verb_mask(device="cuda")
    model = build_model(dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        model(batch, ovm)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        roi_align_cuda.launches = 0
        times = []
        for _ in range(requests):
            t0 = time.perf_counter()
            out = model(batch, ovm)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = roi_align_cuda.launches

    scores = out.scores
    if scores.shape != (BATCH, 15, 30, 117) or not torch.isfinite(scores).all():
        raise AssertionError(f"main path: scores {tuple(scores.shape)}, finite={torch.isfinite(scores).all()}")
    if launches != requests:
        raise AssertionError(f"main path: roi_align launched {launches} times in {requests} requests")
    total = sum(times)
    log(f"[main] bf16 SCG {CANVAS[0]}x{CANVAS[1]} batch {BATCH}: {requests} requests, "
        f"per request ms {[round(t * 1e3, 3) for t in times]}, "
        f"{BATCH * requests / total:.2f} img/s (median {BATCH / sorted(times)[len(times) // 2]:.2f}), "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"roi_align launches {launches}, n_h {out.n_h.tolist()} n {out.n.tolist()}")

    ref = build_model(dtype=torch.float32, device="cuda")
    with torch.no_grad():
        ref_scores = ref(batch, ovm).scores
    err = (scores - ref_scores).abs().max().item()
    log(f"[main] bf16 vs fp32 scores, same weights and batch: max|d| {err:.3e} (atol 5e-2), "
        f"max score {ref_scores.max().item():.4f}")
    if err > 5e-2:
        raise AssertionError("main path: bf16 scores too far from fp32")
    del ref

    if profile_dir:
        profile_forward(model, batch, ovm, profile_dir, sorted(times)[len(times) // 2])
    return launches


def _map_grads(fn, maps, cot):
    """Gradients of ``sum(fn(maps) * cot)`` with respect to each map."""
    leaves = [m.detach().requires_grad_(True) for m in maps]
    (fn(leaves).float() * cot.float()).sum().backward()
    return [m.grad for m in leaves]


def adjoint_bounds(shapes, n_boxes, elem):
    """Least time for the adjoint: (bytes ms, GEMM-operation ms, bytes, ops).
    Bytes: the cotangent and boxes read once, the four map gradients written
    once.  Operations: the two GEMMs of each level as they are formulated
    (every box at every level, the other levels' boxes masked to zero), at
    the float32 rate outside the tensor cores (TF32 is off)."""
    bsz, c = shapes[0][0], shapes[0][3]
    n_bytes = (bsz * n_boxes * 49 * c + sum(b * h * w * c for b, h, w, _ in shapes)) * elem
    n_bytes += bsz * n_boxes * 16
    ops = sum(2 * bsz * n_boxes * 7 * w * 7 * c + 2 * bsz * h * w * c * 7 * n_boxes
              for _, h, w, _ in shapes)
    return n_bytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS_PER_S * 1e3, n_bytes, ops


def phase_adjoint(main_boxes):
    """The kernel's autograd node against autograd through the plain version,
    then the adjoint alone timed against its bounds."""
    from torch.profiler import ProfilerActivity, profile

    from skghoi_torch.ops.roi_align import multiscale_roi_align, roi_align_adjoint
    from skghoi_torch.ops.roi_align_cuda import RoIAlignFunction

    g = torch.Generator(device="cuda").manual_seed(7)
    maps32 = [torch.randn(BATCH, CANVAS[0] // s, CANVAS[1] // s, 256, device="cuda", generator=g)
              for s in (4, 8, 16, 32)]
    maps16 = [m.bfloat16() for m in maps32]
    cases = [("main", main_boxes), ("edge", torch.tensor([EDGE_BOXES] * BATCH, device="cuda")),
             ("map_edges", torch.tensor([MAP_EDGE_BOXES] * BATCH, device="cuda"))]
    errs = {}
    for name, boxes in cases:
        cot = torch.randn(*boxes.shape[:2], 7, 7, 256, device="cuda", generator=g)
        plain = lambda m: multiscale_roi_align(m, boxes)  # noqa: E731
        node = lambda m: RoIAlignFunction.apply(boxes, *m)  # noqa: E731
        ref = _map_grads(plain, maps32, cot)
        ref_abs = _map_grads(plain, maps32, cot.abs())
        got32 = _map_grads(node, maps32, cot)
        got16 = _map_grads(node, maps16, cot.bfloat16())
        for l, (r, ra, a, b) in enumerate(zip(ref, ref_abs, got32, got16)):
            if a.dtype != torch.float32 or b.dtype != torch.bfloat16 or a.shape != r.shape:
                raise AssertionError(f"adjoint {name} level {l}: {a.dtype} {b.dtype} {tuple(a.shape)}")
            ok32 = torch.allclose(a, r, **ADJOINT_TOL)
            excess = ((b.float() - r).abs() - 2.0 ** -8 * (r.abs() + ra)).max().item()
            errs[(name, l)] = ((a - r).abs().max().item(), (b.float() - r).abs().max().item())
            log(f"[adjoint] {name} boxes {tuple(boxes.shape)} P{l + 2}: fp32 max|node-plain| "
                f"{errs[(name, l)][0]:.3e} (rtol 1e-3, atol 1e-4) {'ok' if ok32 else 'FAIL'}; "
                f"bf16 max|node-plain fp32| {errs[(name, l)][1]:.3e}, largest excess over "
                f"2^-8 (|ref| + A|g|) {excess:.3e} {'ok' if excess <= 0 else 'FAIL'}; "
                f"max|ref| {r.abs().max().item():.3e}")
            if not ok32 or excess > 0:
                raise AssertionError(f"RoIAlign gradient disagrees with the plain version "
                                     f"({name}, level {l})")
    if not any(r.abs().max() > 0 for r in ref):
        raise AssertionError("adjoint: the reference gradient is 0; the check would be vacuous")

    shapes = [tuple(m.shape) for m in maps16]
    cot = torch.randn(*main_boxes.shape[:2], 7, 7, 256, device="cuda", generator=g).bfloat16()
    run = lambda: roi_align_adjoint(shapes, torch.bfloat16, main_boxes, cot)  # noqa: E731
    ms = cuda_ms(run, iters=20)
    device_ms = queued_ms(run, reps=5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS)
    bytes_ms, ops_ms, n_bytes, ops = adjoint_bounds(shapes, main_boxes.shape[1], 2)
    log(f"[adjoint] bf16 B={BATCH} N={main_boxes.shape[1]} C=256 832x1344 pyramid: "
        f"{ms:.4f} ms a call (eager, CUDA events), {device_ms:.4f} ms of device time (queued "
        f"behind a sleep, so host launches are hidden), {launches} device launches a call; "
        f"byte bound {bytes_ms:.4f} ms ({n_bytes / 1e6:.1f} MB), GEMM-operation bound "
        f"{ops_ms:.4f} ms ({ops / 1e9:.1f} GFLOP at the fp32 rate): device time at "
        f"{bytes_ms / device_ms:.1%} of the byte bound, {ops_ms / device_ms:.1%} of the "
        f"operation bound")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=8))
    return dict(name="roi_align_adjoint", route="torch (cuBLAS GEMMs)",
                source="skghoi_torch/ops/roi_align.py::roi_align_adjoint",
                replaces="skghoi_tpu/ops/pallas_roi_align.py:222-265", ms=ms,
                device_ms=device_ms, launches_per_call=launches, bytes_bound_ms=bytes_ms,
                ops_bound_ms=ops_ms,
                max_abs_err_fp32=max(e[0] for e in errs.values()),
                max_abs_err_bf16=max(e[1] for e in errs.values()))


def phase_train_parity():
    """The float32 train step on the card against the same step on the CPU."""
    from skghoi_torch.entry import build_model, make_batch, verb_mask
    from skghoi_torch.models.graph_head import gumbel_noise
    from skghoi_torch.parallel.train_step import build_train_step
    from skghoi_torch.train.optimizer import build_optimizer

    gumbel = gumbel_noise((2, 15 * 30 * 117), torch.Generator().manual_seed(3), "cpu")
    res = {}
    for dev in ("cpu", "cuda"):
        model = build_model(dtype=torch.float32, device=dev, seed=PARITY_SEED)
        step = build_train_step(model, build_optimizer(model), verb_mask(device=dev))
        _, losses, _, applied = step(make_batch(2, (64, 96), with_targets=True, device=dev),
                                     gumbel=gumbel.to(dev))
        if not applied:
            raise AssertionError(f"train parity: the step on {dev} was not applied")
        res[dev] = ({k: float(v) for k, v in losses.items()},
                    {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None})
    (cpu_l, cpu_g), (gpu_l, gpu_g) = res["cpu"], res["cuda"]
    loss_err = max(abs(gpu_l[k] / cpu_l[k] - 1) for k in cpu_l)
    if cpu_g.keys() != gpu_g.keys():
        raise AssertionError("train parity: different parameters got gradients")

    def excess(n):  # max|d g| over max|g_cpu|; a gradient that is 0 on the CPU must be 0 here
        diff = (gpu_g[n] - cpu_g[n]).abs().max().item()
        scale = cpu_g[n.replace("adjacency.bias", "adjacency.weight")].abs().max().item()
        return diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)

    worst = max((excess(n), n) for n in cpu_g)
    log(f"[train parity] fp32 step cuda vs cpu, 64x96 batch 2: losses {cpu_l}, largest relative "
        f"difference {loss_err:.3e} (rtol 1e-5); {len(cpu_g)} gradients, largest "
        f"max|d g| / max|g_cpu| {worst[0]:.3e} ({worst[1]}; limit 1e-3)")
    if loss_err > 1e-5 or worst[0] > 1e-3 or min(cpu_l.values()) <= 0:
        raise AssertionError("train parity: the step on the card differs from the CPU's")


def phase_train(profile_dir):
    """The training main path through ``entry.train_entry``."""
    from skghoi_torch.entry import train_entry
    from skghoi_torch.ops.roi_align_cuda import RoIAlignFunction, roi_align_cuda

    step, (batch, generator) = train_entry(device="cuda")
    model, opt = step.model, step.optimizer
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    stem = ("detector.backbone.conv1.", "detector.backbone.layer1.")
    if not frozen or any(not n.startswith(stem) for n in frozen):
        raise AssertionError(f"train: frozen parameters are not the stem and layer1: {sorted(frozen)}")
    before = [[p.detach().clone() for p in g["params"]] for g in opt.param_groups]

    step(batch, generator)  # warm-up: cuDNN plans, allocator, lazy AdamW state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    roi_align_cuda.launches = 0
    RoIAlignFunction.backward_calls = 0
    times, rows = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        total, losses, out, applied = step(batch, generator)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows.append((applied, {k: float(v) for k, v in losses.items()}))
    launches, adjoints = roi_align_cuda.launches, RoIAlignFunction.backward_calls
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    if not all(a for a, _ in rows) or not all(math.isfinite(v) for _, l in rows for v in l.values()):
        raise AssertionError(f"train: a step was skipped or a loss is not finite: {rows}")
    if launches != TRAIN_STEPS or adjoints != TRAIN_STEPS:
        raise AssertionError(f"train: {launches} kernel launches and {adjoints} adjoints in "
                             f"{TRAIN_STEPS} steps")
    for n, p in model.named_parameters():
        if n in frozen and not torch.equal(p, frozen[n]):
            raise AssertionError(f"train: frozen parameter {n} changed")
    moved = [any(not torch.equal(p, q) for p, q in zip(g["params"], b))
             for g, b in zip(opt.param_groups, before)]
    if [g["name"] for g in opt.param_groups] != ["detector", "head"] or not all(moved):
        raise AssertionError(f"train: groups {[g['name'] for g in opt.param_groups]} moved {moved}")
    median = sorted(times)[len(times) // 2]
    log(f"[train] bf16 SCG {CANVAS[0]}x{CANVAS[1]} batch {BATCH}, frozen_stages=1, AdamW lr "
        f"{[g['lr'] for g in opt.param_groups]}: {TRAIN_STEPS} steps, per step ms "
        f"{[round(t * 1e3, 3) for t in times]}, {BATCH * TRAIN_STEPS / sum(times):.2f} train img/s "
        f"(median {BATCH / median:.2f}), peak memory {peak_gib:.2f} GiB, roi_align launches "
        f"{launches}, adjoints {adjoints}, n_h {out.n_h.tolist()} n {out.n.tolist()}")
    for i, (_, l) in enumerate(rows):
        log(f"[train] step {i + 1} losses {l}")
    log(f"[train] frozen stem + layer1 ({len(frozen)} tensors) unchanged; both groups moved; "
        f"metrics {({k: float(v) for k, v in out.metrics.items()})}")

    # The NaN guard reads one flag on the host, which drains the queue: the
    # device then idles while the host issues the AdamW update.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.step()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    update_ms = cuda_ms(opt.step, iters=5, warmup=1)
    log(f"[train] AdamW update ({sum(p.numel() for g in opt.param_groups for p in g['params'])} "
        f"parameters): host issue {issue_ms:.3f} ms after the guard's sync (the device's idle "
        f"time it causes), device {update_ms:.3f} ms (CUDA events)")
    result = dict(step_ms=[t * 1e3 for t in times], img_per_s=BATCH * TRAIN_STEPS / sum(times),
                  median_img_per_s=BATCH / median, peak_gib=peak_gib, launches=launches,
                  adjoints=adjoints, guard_issue_ms=issue_ms, update_ms=update_ms)
    if profile_dir:
        result.update(profile_train_step(step, batch, generator, profile_dir, median))
    return result


def device_events(events):
    """The device rows of a profile's ``key_averages()``: kernels, copies and
    memsets.  A ``record_function`` range (``Optimizer.step#Adam.step``) also
    gets a device row spanning the kernels it wraps; counting it would count
    those kernels twice."""
    from torch.autograd import DeviceType

    return [e for e in events
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def profile_train_step(step, batch, generator, profile_dir, step_s):
    """One traced train step: device busy time and idle share, top operations."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(batch, generator)
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(profile_dir, "scg_bf16_train_step.json"))
    events = prof.key_averages()
    device = device_events(events)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    log(events.table(sort_by="self_device_time_total", row_limit=20))
    idle = max(0.0, 1 - busy_ms / (step_s * 1e3))
    log(f"[profile] one bf16 train step: device busy {busy_ms:.3f} ms in "
        f"{sum(e.count for e in device)} device ops; median step {step_s * 1e3:.3f} ms, so the "
        f"device idles {idle:.1%} of a step")
    return dict(device_busy_ms=busy_ms, idle_share=idle)


class Tee:
    """Writes to the real stdout and keeps a copy (the CLI's log lines)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def run_cli(main, argv):
    """``main(argv)`` with its standard output shown and returned."""
    import contextlib

    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = main(argv)
    return result, tee.text()


def check_device_preprocess(root):
    """``device_resize_canvas`` on the card against the same function on the
    CPU (atol 1e-6) and against the host ``prepare_image`` on the synthetic
    images of both partitions.  The device path keeps the JAX package's
    arithmetic, whose float32 resize ratio moves an output's sample position
    by up to ``in_size * 2^-24`` pixels per axis (the host computes in
    float64), so the host bound is the JAX suite's 2e-5 plus
    ``(h + w) * 2^-24`` (at 480x640: 8.7e-5)."""
    import numpy as np

    from skghoi_torch.data.device_preprocess import device_resize_canvas
    from skghoi_torch.data.hicodet import HICODet
    from skghoi_torch.data.transforms import canvas_for, prepare_image, resize_scale, resized_size

    worst = {}
    for part in ("train2015", "test2015"):
        ds = HICODet(os.path.join(root, "hico_20160224_det/images", part),
                     os.path.join(root, f"instances_{part}.json"))
        images = [ds[i][0] for i in range(len(ds))]
        h, w = images[0].shape[:2]
        canvas = canvas_for(h, w)
        nh, nw = (min(a, b) for a, b in zip(resized_size(h, w, resize_scale(h, w)), canvas))
        raw = torch.from_numpy(np.stack(images))
        sizes = torch.tensor([[h, w]] * len(images), dtype=torch.float32)
        new = torch.tensor([[nh, nw]] * len(images), dtype=torch.float32)
        got = device_resize_canvas(raw.cuda(), sizes.cuda(), new.cuda(), canvas).cpu().numpy()
        cpu = device_resize_canvas(raw, sizes, new, canvas).numpy()
        host_tol = 2e-5 + (h + w) * 2.0 ** -24
        errs = [float(np.abs(got - cpu).max()), 0.0]
        for img, dev in zip(images, got):
            host, hw, _ = prepare_image(img, canvas)
            if hw != (nh, nw):
                raise AssertionError(f"device preprocess: host size {hw}, device {(nh, nw)}")
            errs[1] = max(errs[1], float(np.abs(dev - host).max()))
        ok = errs[0] <= 1e-6 and errs[1] <= host_tol
        log(f"[cli] device_resize_canvas on the card vs the CPU / vs host prepare_image, {part} "
            f"({len(images)} images {h}x{w} -> {nh}x{nw} in {canvas}): max|d| {errs[0]:.3e} "
            f"(atol 1e-6) / {errs[1]:.3e} (atol {host_tol:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("device preprocess disagrees with the host pipeline")
        worst[part] = errs
    return worst


def time_host_pipeline(root, reps: int = 3):
    """Host cost of each stage of a training batch, one thread, median of
    ``reps``: JPEG decode and resize into the canvas per image, the collate
    of one batch, and its copy to the card through pinned memory."""
    import numpy as np

    from skghoi_torch.data.factory import collate, to_device
    from skghoi_torch.data.hicodet import HICODet
    from skghoi_torch.data.transforms import canvas_for, prepare_image

    ds = HICODet(os.path.join(root, "hico_20160224_det/images/train2015"),
                 os.path.join(root, "instances_train2015.json"))
    paths = [os.path.join(root, "hico_20160224_det/images/train2015", ds.filename(i))
             for i in range(BATCH)]

    def timed(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[reps // 2] * 1e3, out

    decode_ms, images = timed(lambda: [ds.load_image(p) for p in paths])
    canvas = canvas_for(*images[0].shape[:2])
    resize_ms, canvases = timed(lambda: [prepare_image(im, canvas)[0] for im in images])
    samples = [dict(image=c, image_size=np.asarray([800, 1066], np.float32),
                    original_size=np.asarray(im.shape[:2], np.float32), canvas=canvas,
                    det_boxes=np.zeros((20, 4), np.float32), det_labels=np.zeros(20, np.int32),
                    det_scores=np.zeros(20, np.float32), gt_boxes_h=np.zeros((2, 4), np.float32),
                    gt_boxes_o=np.zeros((2, 4), np.float32), gt_object=np.zeros(2, np.int32),
                    gt_labels=np.zeros(2, np.int32)) for c, im in zip(canvases, images)]
    collate_ms, batch = timed(lambda: collate(samples))
    copy_ms, _ = timed(lambda: to_device(batch))
    out = dict(decode_ms_per_image=decode_ms / BATCH, resize_ms_per_image=resize_ms / BATCH,
               collate_ms_per_batch=collate_ms, copy_ms_per_batch=copy_ms)
    log(f"[cli] host pipeline, one thread, {images[0].shape[0]}x{images[0].shape[1]} JPEG -> "
        f"{canvas} canvas, batch {BATCH}: decode {out['decode_ms_per_image']:.2f} ms an image, "
        f"resize {out['resize_ms_per_image']:.2f} ms an image, collate {collate_ms:.2f} ms a "
        f"batch, pinned copy to the card {copy_ms:.2f} ms a batch "
        f"({batch.images.nbytes / 1e6:.1f} MB of images)")
    return out


def phase_cli():
    """The CLI path at full width on the card: ``train_hicodet`` for two
    epochs on synthetic HICO-DET (landscape train split, portrait validation
    split), resume, ``test_hicodet``, the device preprocess, and one
    ``--device-resize`` epoch."""
    import re
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from skghoi_torch.data.synthetic import make_synthetic_hicodet
    from skghoi_torch.ops.roi_align_cuda import RoIAlignFunction, roi_align_cuda
    from skghoi_torch.tools import test_hicodet, train_hicodet
    from skghoi_torch.train.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory(prefix="skghoi_cli_") as root:
        t0 = time.perf_counter()
        make_synthetic_hicodet(root, "train2015", num_images=CLI_TRAIN_IMAGES, image_size=(480, 640))
        make_synthetic_hicodet(root, "test2015", num_images=CLI_TEST_IMAGES, image_size=(640, 480))
        log(f"[cli] synthetic HICO-DET written in {time.perf_counter() - t0:.2f} s: train2015 "
            f"{CLI_TRAIN_IMAGES} images 480x640, test2015 {CLI_TEST_IMAGES} images 640x480 (JPEG)")
        data = ["--data-root", root,
                "--train-detection-dir", os.path.join(root, "detections_train2015"),
                "--val-detection-dir", os.path.join(root, "detections_test2015"),
                "--batch-size", str(BATCH), "--print-interval", "1", "--num-workers", "4"]
        ckpts = os.path.join(root, "checkpoints")
        train_argv = ["--partitions", "train2015", "test2015", "--num-epochs", "2",
                      "--cache-dir", ckpts] + data

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        roi_align_cuda.launches = 0
        RoIAlignFunction.backward_calls = 0
        t0 = time.perf_counter()
        engine, text = run_cli(train_hicodet.main, train_argv)
        train_s = time.perf_counter() - t0
        launches, adjoints = roi_align_cuda.launches, RoIAlignFunction.backward_calls
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        steps_per_epoch = CLI_TRAIN_IMAGES // BATCH
        steps, val_batches = 2 * steps_per_epoch, 2 * math.ceil(CLI_TEST_IMAGES / BATCH)
        epochs = re.findall(r"^Epoch: .*$", text, re.M)
        losses = [float(x) for line in re.findall(r"^=> HOI classification loss: .*$", text, re.M)
                  for x in re.findall(r"-?\d+\.\d+|nan|inf", line)]
        if len(epochs) != 2 or "Training complete." not in text:
            raise AssertionError(f"cli: {len(epochs)} Epoch lines")
        if len(losses) != 3 * steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"cli: losses {losses}")
        for name in ("ckpt_01.pt", "ckpt_02.pt"):
            if not os.path.exists(os.path.join(ckpts, name)):
                raise AssertionError(f"cli: {name} was not written")
        if launches != steps + val_batches or adjoints != steps:
            raise AssertionError(f"cli: {launches} kernel launches and {adjoints} adjoints for "
                                 f"{steps} train steps and {val_batches} validation batches")
        ends = engine.iteration_ends
        # Loader-inclusive steps after the first of each epoch (the first
        # step of epoch 2 also waits out validation and the checkpoint).
        gaps = [b - a for e in range(2) for a, b in
                zip(ends[e * steps_per_epoch:(e + 1) * steps_per_epoch],
                    ends[e * steps_per_epoch + 1:(e + 1) * steps_per_epoch])]
        train_img_s = BATCH * len(gaps) / sum(gaps)
        log(f"[cli] train_hicodet, float32 (TF32 off), {CANVAS[0]}x{CANVAS[1]} batch {BATCH}, "
            f"2 epochs of {steps_per_epoch} steps, portrait validation: {train_s:.2f} s in all; "
            f"steps after the first of each epoch {[round(g * 1e3, 3) for g in gaps]} ms, "
            f"{train_img_s:.2f} train img/s with the loader; peak memory {peak_gib:.2f} GiB; "
            f"roi_align launches {launches} ({steps} steps + {val_batches} validation batches), "
            f"adjoints {adjoints}")
        for line in epochs:
            log(f"[cli] {line}")

        # Resume from the first epoch's checkpoint into a fresh engine.
        resumed, _ = run_cli(train_hicodet.main, ["--partitions", "train2015", "test2015",
                                                  "--num-epochs", "0", "--cache-dir",
                                                  os.path.join(root, "resumed"),
                                                  "--checkpoint-path",
                                                  os.path.join(ckpts, "ckpt_01.pt")] + data)
        saved = load_checkpoint(os.path.join(ckpts, "ckpt_01.pt"))
        opt = resumed.optimizer
        state = opt.state_dict()
        params_equal = all(torch.equal(v.cpu(), saved["model_state_dict"][k])
                           for k, v in resumed.model.state_dict().items())
        moments_equal = all(torch.equal(s[k].cpu(), saved["optim_state_dict"]["state"][i][k])
                            for i, s in state["state"].items() for k in ("exp_avg", "exp_avg_sq"))
        applied = [g["applied_steps"] for g in opt.param_groups]
        if (resumed.epoch != 1 or resumed.iteration != steps_per_epoch
                or applied != [steps_per_epoch] * 2 or not params_equal or not moments_equal
                or [g["lr"] for g in opt.param_groups]
                != [g["lr"] for g in saved["optim_state_dict"]["param_groups"]]):
            raise AssertionError(f"cli resume: epoch {resumed.epoch}, applied {applied}, "
                                 f"params equal {params_equal}, moments equal {moments_equal}")
        log(f"[cli] resumed from ckpt_01.pt: epoch {resumed.epoch}, iteration "
            f"{resumed.iteration}, applied steps {applied}, lr "
            f"{[g['lr'] for g in opt.param_groups]}; parameters and AdamW moments equal the file")

        # One traced epoch of the resumed run: the device's idle share.
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_cli(lambda _: resumed.run(1), None)
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t0
        device = device_events(prof.key_averages())
        busy_ms = sum(e.self_device_time_total for e in device) / 1e3
        idle = max(0.0, 1 - busy_ms / (epoch_s * 1e3))
        log(f"[cli] one traced epoch ({steps_per_epoch} steps, validation, checkpoint): "
            f"{epoch_s * 1e3:.1f} ms, device busy {busy_ms:.1f} ms in "
            f"{sum(e.count for e in device)} device ops: idle {idle:.1%}")

        # What the loop spends beside the step: the step alone on a batch
        # already on the card, and the checkpoint write.
        from skghoi_torch.data.factory import to_device

        batch = to_device(next(iter(resumed.train_loader))[0])
        step_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resumed.train_step(batch, generator=resumed.generator)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        resumed.save()
        save_ms = (time.perf_counter() - t0) * 1e3
        log(f"[cli] the float32 train step alone on a batch on the card: {step_ms} ms "
            f"({BATCH * 1e3 / sorted(step_ms)[1]:.2f} img/s at the median); one checkpoint "
            f"write {save_ms:.1f} ms")
        del resumed, engine, batch

        # Evaluate the second epoch's checkpoint on the portrait split.
        roi_align_cuda.launches = 0
        result, _ = run_cli(test_hicodet.main, [
            "--data-root", root, "--detection-dir", os.path.join(root, "detections_test2015"),
            "--partition", "test2015", "--model-path", os.path.join(ckpts, "ckpt_02.pt"),
            "--batch-size", str(BATCH)])
        test_launches = roi_align_cuda.launches
        maps = [result[k] for k in ("full", "rare", "non_rare")]
        if not all(math.isfinite(m) and 0.0 <= m <= 1.0 for m in maps):
            raise AssertionError(f"cli test: mAP {maps}")
        if test_launches != math.ceil(CLI_TEST_IMAGES / BATCH):
            raise AssertionError(f"cli test: {test_launches} kernel launches")
        eval_img_s = CLI_TEST_IMAGES / result["seconds"]
        log(f"[cli] test_hicodet on test2015 ({PORTRAIT[0]}x{PORTRAIT[1]}) with ckpt_02.pt: "
            f"full/rare/non-rare mAP {maps}, {result['seconds']:.3f} s, {eval_img_s:.2f} eval "
            f"img/s with the (synchronous) loader; roi_align launches {test_launches}")

        preprocess_err = check_device_preprocess(root)
        host = time_host_pipeline(root)

        roi_align_cuda.launches = 0
        RoIAlignFunction.backward_calls = 0
        dr_engine, text = run_cli(train_hicodet.main, [
            "--partitions", "train2015", "--num-epochs", "1", "--device-resize",
            "--cache-dir", os.path.join(root, "device_resize")] + data)
        ends = dr_engine.iteration_ends
        dr_gaps = [b - a for a, b in zip(ends, ends[1:])]
        dr_losses = [float(x) for line in re.findall(r"^=> HOI .*$", text, re.M)
                     for x in re.findall(r"-?\d+\.\d+|nan|inf", line)]
        if (len(re.findall(r"^Epoch: ", text, re.M)) != 1 or len(dr_losses) != 3 * steps_per_epoch
                or not all(math.isfinite(v) for v in dr_losses)
                or roi_align_cuda.launches != steps_per_epoch
                or RoIAlignFunction.backward_calls != steps_per_epoch):
            raise AssertionError(f"cli --device-resize: losses {dr_losses}, launches "
                                 f"{roi_align_cuda.launches}")
        log(f"[cli] --device-resize epoch: {steps_per_epoch} steps, losses finite, roi_align "
            f"launches {roi_align_cuda.launches}, adjoints {RoIAlignFunction.backward_calls}; "
            f"steps after the first {[round(g * 1e3, 3) for g in dr_gaps]} ms with the loader")

    return dict(dtype="float32", tf32=False, canvas=list(CANVAS), batch=BATCH,
                train_img_per_s=train_img_s, train_step_ms=[g * 1e3 for g in gaps],
                eval_img_per_s=eval_img_s, idle_share_traced_epoch=idle,
                traced_epoch_ms=epoch_s * 1e3, device_busy_ms=busy_ms, peak_gib=peak_gib,
                step_alone_ms=step_ms, checkpoint_ms=save_ms,
                train_steps=steps, val_batches=val_batches, launches=launches,
                adjoints=adjoints, test_launches=test_launches,
                map=dict(zip(("full", "rare", "non_rare"), maps)),
                device_preprocess_max_err=preprocess_err, host_pipeline=host,
                device_resize_step_ms=[g * 1e3 for g in dr_gaps])


# Published sizes of the KGE benchmarks (OpenKE benchmarks/*/{entity,relation,train,valid,test}2id.txt).
FB15K237 = dict(name="FB15K237", ent=14541, rel=237, train=272115, valid=17535, test=20466)
WN18RR = dict(name="WN18RR", ent=40943, rel=11, train=86835, valid=3034, test=3134)
KGE_EPOCHS = 5        # phase 9b: train_kge epochs, enough to show the loss falling
KGE_WN_EPOCHS = 2     # phase 9c
KGE_PARITY_STEPS = 3  # phase 9a: trainer steps held card vs CPU
KGE_PARITY_TEST = 512  # phase 9a: test triples ranked card vs CPU
KGE_TIMED_EPOCHS = 3  # per preset, each timed alone after one warm-up epoch
TIE_TOL = 2.0 ** -20  # a rank may differ only where scores tie within this share of the row's max


def write_synthetic_kg(root, sizes, seed=0):
    """A seeded KG at a benchmark's published sizes, in OpenKE's ``*2id.txt``
    format with ``type_constrain.txt``: heads, tails and relations drawn from
    Zipf-like popularity (weight ``1 / rank^0.8`` over a shuffled order),
    unique triples without self-loops, valid and test disjoint from train."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_ent, n_rel = sizes["ent"], sizes["rel"]
    total = sizes["train"] + sizes["valid"] + sizes["test"]

    def popularity(n):
        w = 1.0 / np.arange(1, n + 1) ** 0.8
        return rng.permutation(n), w / w.sum()

    (ent_order, ent_p), (rel_order, rel_p) = popularity(n_ent), popularity(n_rel)
    keys = np.zeros(0, np.int64)
    while len(keys) < total:
        n = int((total - len(keys)) * 1.3) + 1000
        h = ent_order[rng.choice(n_ent, n, p=ent_p)]
        t = ent_order[rng.choice(n_ent, n, p=ent_p)]
        r = rel_order[rng.choice(n_rel, n, p=rel_p)]
        new = ((h * n_rel + r) * n_ent + t)[h != t]
        merged = np.concatenate([keys, new])
        _, first = np.unique(merged, return_index=True)
        keys = merged[np.sort(first)]
    keys = rng.permutation(keys[:total])
    triples = np.stack([keys // (n_rel * n_ent), keys % n_ent, (keys // n_ent) % n_rel], 1)
    os.makedirs(root, exist_ok=True)
    for name, n in (("entity2id.txt", n_ent), ("relation2id.txt", n_rel)):
        with open(os.path.join(root, name), "w") as f:
            f.write(f"{n}\n" + "".join(f"/m/e{i}\t{i}\n" for i in range(n)))
    bounds = np.cumsum([0, sizes["train"], sizes["valid"], sizes["test"]])
    for name, lo, hi in zip(("train2id.txt", "valid2id.txt", "test2id.txt"), bounds, bounds[1:]):
        with open(os.path.join(root, name), "w") as f:
            f.write(f"{hi - lo}\n")
            np.savetxt(f, triples[lo:hi], fmt="%d")
    with open(os.path.join(root, "type_constrain.txt"), "w") as f:
        f.write(f"{n_rel}\n")
        for r in range(n_rel):
            for col in (0, 1):
                ents = np.unique(triples[triples[:, 2] == r, col])
                f.write(f"{r} {len(ents)} " + " ".join(map(str, ents)) + "\n")
    return root


def kge_step_bytes(args, data):
    """Bytes one training step must move: every gathered embedding row read
    once and its gradient row written once by the backward (``(1 + neg) B``
    rows per entity slot and per relation table), plus the dense update of
    every table (SGD reads parameter and gradient and writes the parameter;
    Adam also reads and writes both moments)."""
    b, k = max(1, int(data.train_total / args.nbatches)), args.neg_ent
    dim, elem = args.dim, 4
    if args.sampling_mode == "oneside":
        ent_rows, rel_rows = b * (2 + k), b
    else:
        ent_rows, rel_rows = 2 * b * (1 + k), b * (1 + k)
    rel_tables = 2 if args.model == "transh" else 1  # TransH: rel_embeddings + norm_vector
    gathered = (ent_rows + rel_tables * rel_rows) * dim * elem
    params = (data.ent_tot + rel_tables * data.rel_tot) * dim * elem
    passes = 7 if args.opt == "adam" else 3
    return 2 * gathered + passes * params


def rank_mismatches(got, want, scores_of):
    """Ranks of two runs may differ only where the ground truth's score ties
    another entity's within ``TIE_TOL`` of the row's largest score, and by no
    more than the number of such entities (``scores_of(side, i)`` gives the
    row); returns the count of such ties.  How many there are depends on how
    densely the entities' scores crowd the ground truth's (near the initial
    tables at dim 1 024 and 40 943 entities, about one rank in eight), so the
    count is reported, not bounded."""
    import numpy as np

    ties = 0
    for key in got:
        for i in np.flatnonzero(got[key] != want[key]):
            side = key.split("_")[0]
            row, gt = scores_of(side, i)
            near = np.abs(row - row[gt]) <= TIE_TOL * np.abs(row).max()
            near[gt] = False
            if not near.any() or abs(int(got[key][i]) - int(want[key][i])) > near.sum():
                raise AssertionError(f"ranks differ without a tie: {key}[{i}] {got[key][i]} "
                                     f"vs {want[key][i]}")
            ties += 1
    return ties


def kge_parity(root, example, steps=KGE_PARITY_STEPS):
    """``steps`` trainer steps of the preset on the card and on the CPU from
    the same seeded state on the same batches (drawn by the sampler on the
    CPU); then the ranks of the first ``KGE_PARITY_TEST`` test triples under
    the CPU's trained tables on both, equal but for counted float ties.

    The steps run in float32 and in float64.  In float64 every parameter is
    within 1e-5 of its tensor's max.  In float32 so is every parameter
    outside the few rows where an L1 distance component sits at rounding
    level: ``|x|``'s gradient is ``sign(x)``, and where the two devices round
    ``x`` to opposite signs the row takes a step of another sign (the same
    happens between float32 and float64 on one device).  At most
    ``2 * steps`` rows a table may differ so."""
    import dataclasses

    from skghoi_torch.kge import KGData, Tester
    from skghoi_torch.kge.sampling import DeviceKG, sample_batch, sample_batch_oneside
    from skghoi_torch.tools import train_kge

    args = train_kge.parse_args(["--data", root, "--example", example])
    data = KGData.load(root)
    data = dataclasses.replace(data, test=data.test[:KGE_PARITY_TEST])
    kg_cpu = DeviceKG.from_kgdata(data, "cpu")
    sampler = sample_batch_oneside if args.sampling_mode == "oneside" else sample_batch
    g = torch.Generator().manual_seed(11)
    batches = [sampler(g, kg_cpu, max(1, int(data.train_total / args.nbatches)), args.neg_ent,
                       bern=args.bern) for _ in range(steps)]
    out = {}
    for dtype in (torch.float32, torch.float64):
        models, losses = {}, {}
        for dev in ("cpu", "cuda"):
            model = train_kge.build_model(args, data, torch.device(dev)).to(dtype)
            feed = iter(batches)
            trainer = train_kge.build_trainer(args, model, DeviceKG.from_kgdata(data, dev), steps,
                                              batches=lambda: next(feed))
            losses[dev] = [trainer.step().item() for _ in range(steps)]
            models[dev] = model
        want = models["cpu"].state_dict()
        worst, rows = (0.0, ""), {}
        for n, p in models["cuda"].state_dict().items():
            rel = (p.cpu() - want[n]).abs() / want[n].abs().max()
            worst = max(worst, (rel.max().item(), n))
            rows[n] = len(torch.unique(torch.nonzero(rel > 1e-5)[:, 0]))
        loss_err = max(abs(a / b - 1) for a, b in zip(losses["cuda"], losses["cpu"]))
        name = str(dtype)[6:]
        out[name] = dict(loss_rel_err=loss_err, param_rel_err=worst[0], rows_beyond_1e5=rows)
        log(f"[kge parity] {example} ({args.model} dim {args.dim}, {args.sampling_mode}, "
            f"{args.loss}, {args.opt} {args.alpha}), {name}: {steps} steps card vs CPU on the same "
            f"batches, losses {[round(x, 6) for x in losses['cuda']]} (largest relative difference "
            f"{loss_err:.2e}); parameters largest max|d| / max|p| {worst[0]:.2e} ({worst[1]}), rows "
            f"with an element beyond 1e-5 of the max {rows}")
        limit = 0 if dtype == torch.float64 else 2 * steps
        if loss_err > 1e-5 or any(v > limit for v in rows.values()):
            raise AssertionError(f"kge parity: {example} ({name}) differs between the card and "
                                 f"the CPU")
        if dtype == torch.float32:
            tables = models["cpu"].state_dict()
        del models

    # Rank with the same tables on both, so that only the ranking's own
    # arithmetic differs.
    ranked = {}
    for dev in ("cpu", "cuda"):
        model = train_kge.build_model(args, data, torch.device(dev))
        model.load_state_dict(tables)
        t0 = time.perf_counter()
        got = Tester(model, data).ranks()
        ranked[dev] = ({k: v for k, v in got.items() if not k.endswith("cons")},
                       time.perf_counter() - t0, model)
    cpu_model = ranked["cpu"][2]

    def scores_of(side, i):
        h, t, r = (torch.tensor([x]) for x in data.test[i])
        with torch.no_grad():
            fn = cpu_model.rank_all_heads if side == "head" else cpu_model.rank_all_tails
            row = fn(t if side == "head" else h, r)[0]
        return row.numpy(), int(data.test[i][0 if side == "head" else 1])

    ties = rank_mismatches(ranked["cuda"][0], ranked["cpu"][0], scores_of)
    n_ranks = len(data.test) * len(ranked["cpu"][0])
    log(f"[kge parity] {example}: with the float32 CPU tables on both, the raw and filtered ranks "
        f"of {len(data.test)} test triples (both sides) are equal but {ties} of {n_ranks}, each "
        f"at a float tie; ranking {ranked['cuda'][1]:.3f} s on the card, {ranked['cpu'][1]:.3f} s "
        f"on the CPU")
    return dict(out, rank_ties=ties, ranks=n_ranks, rank_card_s=ranked["cuda"][1],
                rank_cpu_s=ranked["cpu"][1])


def time_kge_epochs(root, example):
    """The preset's trainer as ``train_kge`` builds it: one warm-up epoch,
    ``KGE_TIMED_EPOCHS`` epochs timed alone, one traced epoch (device busy
    and idle share)."""
    from torch.profiler import ProfilerActivity, profile

    from skghoi_torch.kge import KGData
    from skghoi_torch.kge.sampling import DeviceKG
    from skghoi_torch.tools import train_kge

    args = train_kge.parse_args(["--data", root, "--example", example])
    data = KGData.load(root)
    model = train_kge.build_model(args, data, torch.device("cuda"))
    trainer = train_kge.build_trainer(args, model, DeviceKG.from_kgdata(data, "cuda"), 1)
    trainer.run_epoch().item()
    times = []
    for _ in range(KGE_TIMED_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run_epoch().item()
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_epoch().item()
        traced_s = time.perf_counter() - t0
    device = device_events(prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    n_ops = sum(e.count for e in device)
    epoch_s = sorted(times)[len(times) // 2]
    triples = trainer.batch_size * (1 + args.neg_ent) * args.nbatches
    n_bytes = kge_step_bytes(args, data)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    if not busy_ms:
        raise AssertionError("kge: the profiler saw no device time in the traced epoch")
    out = dict(example=example, model=args.model, dim=args.dim, batch=trainer.batch_size,
               neg=args.neg_ent, nbatches=args.nbatches, epoch_ms=[t * 1e3 for t in times],
               epoch_ms_median=epoch_s * 1e3, step_ms=epoch_s * 1e3 / args.nbatches,
               device_ms_per_step=busy_ms / args.nbatches, device_ops_per_step=n_ops / args.nbatches,
               idle_share=max(0.0, 1 - busy_ms / (traced_s * 1e3)),
               train_triples_per_s=triples / epoch_s, step_bytes=n_bytes, step_bound_ms=bound_ms)
    log(f"[kge] {example} epoch ({args.nbatches} steps of {trainer.batch_size} x (1 + "
        f"{args.neg_ent}) triples): ms {[round(t * 1e3, 3) for t in times]}, median "
        f"{epoch_s * 1e3:.3f} ({out['step_ms']:.4f} ms a step), {out['train_triples_per_s']:.0f} "
        f"train triples/s with negatives; traced epoch {traced_s * 1e3:.3f} ms, device busy "
        f"{busy_ms:.3f} ms in {n_ops} device ops ({out['device_ms_per_step']:.4f} ms a step): idle "
        f"{out['idle_share']:.1%}; step byte bound {bound_ms:.4f} ms ({n_bytes / 1e6:.1f} MB): "
        f"device time at {bound_ms / out['device_ms_per_step']:.1%} of it")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=8))
    del trainer, model
    return out


def run_train_kge(argv):
    """``train_kge.main(argv)``; returns (result, its JSON row, the Epoch losses)."""
    import re
    import tempfile

    from skghoi_torch.tools import train_kge

    with tempfile.TemporaryDirectory(prefix="skghoi_kge_json_") as tmp:
        path = os.path.join(tmp, "row.jsonl")
        res, text = run_cli(train_kge.main, argv + ["--json-out", path])
        with open(path) as f:
            row = json.loads(f.read())
    epochs = [float(x) for x in re.findall(r"^Epoch \d+ \| loss: (\S+) \|", text, re.M)]
    return res, row, epochs


def phase_kge():
    """Phase 9: the KGE toolkit on the card, on seeded synthetic KGs at
    FB15K237's and WN18RR's published sizes."""
    import tempfile

    results = dict(parity={}, train_kge={}, epochs={})
    with tempfile.TemporaryDirectory(prefix="skghoi_kge_") as tmp:
        t0 = time.perf_counter()
        fb = write_synthetic_kg(os.path.join(tmp, "fb15k237"), FB15K237, seed=0)
        wn = write_synthetic_kg(os.path.join(tmp, "wn18rr"), WN18RR, seed=1)
        log(f"[kge] synthetic KGs written in {time.perf_counter() - t0:.2f} s: {FB15K237} and {WN18RR}")

        for root, example in ((fb, "transe_fb15k237"), (fb, "transh_fb15k237"), (wn, "transe_wn18rr")):
            results["parity"][example] = kge_parity(root, example)

        for root, example, epochs in ((fb, "transe_fb15k237", KGE_EPOCHS),
                                      (fb, "transh_fb15k237", KGE_EPOCHS),
                                      (wn, "transe_wn18rr", KGE_WN_EPOCHS)):
            ckpt = os.path.join(tmp, f"{example}.pt")
            base = ["--data", root, "--example", example]
            res, row, losses = run_train_kge(base + ["--epochs", str(epochs), "--checkpoint", ckpt])
            if len(losses) < 2 or not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
                raise AssertionError(f"train_kge {example}: epoch losses {losses} do not fall")
            again, row2, _ = run_train_kge(base + ["--epochs", "0", "--load-checkpoint", ckpt])
            if tuple(again) != tuple(res) or again.raw != res.raw:
                raise AssertionError(f"train_kge {example}: the checkpoint reprints {tuple(again)}, "
                                     f"not {tuple(res)}")
            entry = dict(epochs=epochs, loss_first=losses[0], loss_last=losses[-1],
                         train_s=row["train_seconds"], mrr=res.mrr, mr=res.mr, hit10=res.hit10,
                         eval_s=row2["eval_seconds"], device=row["device_name"])
            n_test = FB15K237["test"] if root == fb else WN18RR["test"]
            entry["test_triples_per_s"] = n_test / row2["eval_seconds"]
            if example == "transe_fb15k237":
                cons, row3, _ = run_train_kge(base + ["--epochs", "0", "--load-checkpoint", ckpt,
                                                      "--type-constrain"])
                entry.update(type_constrained=dict(mrr=cons.mrr, mr=cons.mr, hit10=cons.hit10,
                                                   eval_s=row3["eval_seconds"]))
                if not cons.mr <= res.mr:
                    raise AssertionError("type constraints gave a worse filtered MR")
            log(f"[kge] train_kge --example {example}: epoch losses {losses}, {row['train_seconds']:.3f} s "
                f"training; filtered link prediction over {n_test} test triples: MRR {res.mrr:.6f} MR "
                f"{res.mr:.2f} hits@10 {res.hit10:.6f}, {row2['eval_seconds']:.3f} s "
                f"({entry['test_triples_per_s']:.1f} test triples/s); reloaded checkpoint reprints "
                f"the same metrics" + (f"; type-constrained MRR {entry['type_constrained']['mrr']:.6f}"
                                       f" in {entry['type_constrained']['eval_s']:.3f} s"
                                       if "type_constrained" in entry else ""))
            results["train_kge"][example] = entry
            results["epochs"][example] = time_kge_epochs(root, example)
    return results


def phase_vcoco_transh():
    """Phase 10: V-COCO caching and evaluation, and the TransH pretrain path
    into ``train_hicodet --transh-init``."""
    import subprocess as sp
    import tempfile

    from skghoi_torch.data.synthetic import make_synthetic_vcoco
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda
    from skghoi_torch.tools import cache_results, pretrain_transh_hoi, train_hicodet, vcoco_evaluation

    out = {}
    with tempfile.TemporaryDirectory(prefix="skghoi_vcoco_") as root:
        make_synthetic_vcoco(root, "test", num_images=CLI_TEST_IMAGES, image_size=(480, 640))
        roi_align_cuda.launches = 0
        t0 = time.perf_counter()
        run_cli(cache_results.main, [
            "--dataset", "vcoco", "--data-root", root, "--partition", "test",
            "--detection-dir", os.path.join(root, "detections_test"),
            "--cache-dir", os.path.join(root, "cache"), "--batch-size", str(BATCH)])
        cache_s = time.perf_counter() - t0
        launches = roi_align_cuda.launches
        pkl = os.path.join(root, "cache", "vcoco_results.pkl")
        argv = ["--data-root", root, "--det-file", pkl]
        res, _ = run_cli(vcoco_evaluation.main, argv)
        code = ("import json, sys; from skghoi_torch.tools import vcoco_evaluation as v; "
                "r = v.main(sys.argv[1:]); print(json.dumps(r['mean']))")
        cpu = sp.run([sys.executable, "-c", code] + argv, capture_output=True, text=True, check=True,
                     timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)),
                     env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        cpu_mean = json.loads(cpu.stdout.strip().splitlines()[-1])
        if cpu_mean != res["mean"] or launches != math.ceil(CLI_TEST_IMAGES / BATCH):
            raise AssertionError(f"vcoco: mean {res['mean']} vs CPU {cpu_mean}; {launches} launches")
        if not all(0.0 <= v <= 1.0 for v in res["mean"].values()):
            raise AssertionError(f"vcoco: mean role AP {res['mean']}")
        log(f"[vcoco] cache_results --dataset vcoco ({CLI_TEST_IMAGES} images 480x640, float32, "
            f"{CANVAS[0]}x{CANVAS[1]}, batch {BATCH}): {cache_s:.3f} s, roi_align launches {launches}; "
            f"vcoco_evaluation over {len(res['per_action'])} actions: mean {res['mean']}, equal to "
            f"the CPU run of the same pickle")
        out["vcoco"] = dict(mean=res["mean"], actions=len(res["per_action"]), cache_s=cache_s,
                            launches=launches)

    with tempfile.TemporaryDirectory(prefix="skghoi_transh_") as tmp:
        pt = os.path.join(tmp, "transh_hoi.pt")
        t0 = time.perf_counter()
        kge, _ = run_cli(pretrain_transh_hoi.main, ["--synthetic", "--output", pt])
        pretrain_s = time.perf_counter() - t0
        saved = torch.load(pt, map_location="cpu", weights_only=True)
        if next(kge.parameters()).device.type != "cuda":
            raise AssertionError("pretrain_transh_hoi did not train on the card")
        common = ["--synthetic", "--synthetic-root", os.path.join(tmp, "synth"), "--transh-init", pt]
        loaded, _ = run_cli(train_hicodet.main, common + ["--num-epochs", "0", "--cache-dir",
                                                          os.path.join(tmp, "c0")])
        transh = loaded.model.interaction_head.box_pair_head.transh
        equal = all(torch.equal(getattr(transh, t).weight.cpu(), saved[f"{t}.weight"])
                    for t in pretrain_transh_hoi.TRANSH_TABLES)
        del loaded
        roi_align_cuda.launches = 0
        engine, text = run_cli(train_hicodet.main, common + ["--cache-dir", os.path.join(tmp, "c1")])
        launches = roi_align_cuda.launches
        if not equal or "Training complete." not in text or launches != engine.iteration or not launches:
            raise AssertionError(f"transh-init: tables equal {equal}, {launches} launches in "
                                 f"{engine.iteration} steps")
        log(f"[transh] pretrain_transh_hoi --synthetic on the card: {pretrain_s:.3f} s, tables "
            f"{ {k: tuple(v.shape) for k, v in saved.items()} }; train_hicodet --synthetic "
            f"--transh-init: the SCG's TransH tables equal the checkpoint's after loading; one "
            f"epoch of {engine.iteration} steps, roi_align launches {launches}")
        out["transh_init"] = dict(pretrain_s=pretrain_s, tables_equal=equal, steps=engine.iteration,
                                  launches=launches)
    return out


@torch.no_grad()
def profile_forward(model, batch, ovm, profile_dir, request_s):
    """One traced forward (device busy time, kernel count, top ops) and the
    eager time of each stage of the path, by CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    from skghoi_torch import constants as C
    from skghoi_torch.models.interaction_head import filter_detections
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda

    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(batch, ovm)
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(profile_dir, "scg_bf16_forward.json"))
    events = prof.key_averages()
    device = device_events(events)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    n_kernels = sum(e.count for e in device)
    roi = [e for e in events if "roi_align_staged_kernel" in e.key]
    log(events.table(sort_by="self_device_time_total", row_limit=15))
    roi_ms = roi[0].self_device_time_total / roi[0].count / 1e3 if roi else float("nan")
    log(f"[profile] one bf16 forward: device busy {busy_ms:.3f} ms in {n_kernels} device ops; "
        f"median request {request_s * 1e3:.3f} ms, so the device idles "
        f"{max(0.0, 1 - busy_ms / (request_s * 1e3)):.1%} of a request; "
        f"roi_align kernel alone {roi_ms:.4f} ms")

    dt = model.compute_dtype
    mean = torch.tensor(C.IMAGE_MEAN, dtype=dt, device="cuda")
    std = torch.tensor(C.IMAGE_STD, dtype=dt, device="cuda")
    images = (batch.images.to(dt) - mean) / std
    feats = model.detector(images)
    dets = filter_detections(batch.det_boxes, batch.det_labels, batch.det_scores, batch.det_valid)
    head = model.interaction_head
    stages = {
        "backbone (ResNet-50 + FPN)": lambda: model.detector(images),
        "detection filter (NMS loop)": lambda: filter_detections(
            batch.det_boxes, batch.det_labels, batch.det_scores, batch.det_valid),
        "roi_align (wrapper + kernel)": lambda: roi_align_cuda(feats, dets.boxes),
        "interaction head (incl. roi_align)": lambda: head(feats, dets, batch.image_sizes, ovm),
    }
    for name, fn in stages.items():
        log(f"[stage] {name}: {cuda_ms(fn, iters=10):.3f} ms (eager, CUDA events)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default=None, help="directory for a torch.profiler trace")
    ap.add_argument("--baseline-source", default=None,
                    help="another roi_align.cu with the same C interface, timed in turns beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from skghoi_torch.entry import make_batch
    from skghoi_torch.models.interaction_head import filter_detections
    from skghoi_torch.ops.roi_align_cuda import RoIAlignKernel, roi_align_cuda

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    baseline = RoIAlignKernel(Path(args.baseline_source)) if args.baseline_source else None
    for k in (roi_align_cuda, baseline) if baseline else (roi_align_cuda,):
        k.build()
        log(f"[build] {k.source} -> {k.build_dir.name}/ in {k.build_seconds:.2f} s")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")

    b = make_batch(BATCH, CANVAS, device="cuda")
    main_boxes = filter_detections(b.det_boxes, b.det_labels, b.det_scores, b.det_valid).boxes
    main_boxes = main_boxes.contiguous()
    kernel = phase_kernel(main_boxes, baseline)
    phase_parity()
    kernel["launches"] = phase_main(REQUESTS, args.profile)
    adjoint = phase_adjoint(main_boxes)
    phase_train_parity()
    train = phase_train(args.profile)
    kernel["launches_train"] = train["launches"]
    adjoint["calls_train"] = train["adjoints"]
    cli = phase_cli()
    kernel["launches_cli"] = cli["launches"]
    kernel["launches_cli_test"] = cli["test_launches"]
    adjoint["calls_cli"] = cli["adjoints"]
    kge = phase_kge()
    hoi = phase_vcoco_transh()
    kernel["launches_cli_vcoco"] = hoi["vcoco"]["launches"]
    kernel["launches_cli_transh"] = hoi["transh_init"]["launches"]

    log(f"[card] {card}")
    print(json.dumps({"library_ops": [adjoint]}))
    print(json.dumps({"train": train}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"kge": kge}))
    print(json.dumps({"vcoco_transh": hoi}))
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

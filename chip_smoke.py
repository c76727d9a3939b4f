#!/usr/bin/env python3
"""Drive the PyTorch port of the SCG HOI network on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

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
   and the plain version, beside its bound (``hoibench.roofline``).
3. The float32 network on the card against the same network on the CPU
   (64x96, batch 2; TF32 off): scores within 1e-4, filtered boxes and counts
   equal.
4. The main path: the bfloat16 network at full width, 832x1344, batch 8,
   answering ``REQUESTS`` forward requests with the launch counts set to 0
   just before; it checks the scores, that the kernel ran once per request,
   prints img/s, and holds the scores against the float32 network's.
5. The RoIAlign gradient: ``RoIAlignFunction`` (the forward kernel, the
   adjoint kernel backward) against autograd through the plain gather
   version, on the card, with respect to all four maps of the 832x1344
   pyramid (batch 8) for the main path's boxes at C = 256, 136 (a ragged
   last channel slice) and 64; phase 2's edge/overflow, 28x28-grid,
   map-edge, padding-only, B=1 N=1 and 600-random-box (C=64) cases; 100
   boxes an image piled on one tile of P2; and the portrait 1344x832
   pyramid: float32 within rtol 1e-3 / atol 1e-4 (the JAX suite's tolerance
   for this gradient); bfloat16 maps and cotangent against the float32
   reference within ``2^-8 * (|ref| + A|g|)`` per element, where ``A|g|``
   is the adjoint of the cotangent's magnitude (the cotangent's rounding,
   2^-9 relative, plus the result's, with a factor 2 to spare); the kernel
   against ``roi_align_adjoint`` (the GEMM route) on the same inputs within
   rtol = atol = 1e-5 in float32; two calls bit for bit.  Then the kernel
   alone on the main path's inputs (bf16): cold and warm L2 in CUDA graphs,
   queued behind a device sleep, eager, its launches a call, against its
   byte bound (``hoibench.roofline``); the GEMM route's device time and
   launches on the same inputs
   (the library yardstick) and autograd's backward through the plain
   version.
6. The float32 train step on the card against the same step on the CPU
   (64x96, batch 2; TF32 off; the same seeded weights, batch and Gumbel
   noise): the three losses within rtol 1e-5, every gradient within
   ``1e-3 * max|g|`` of the CPU's (the adjacency bias, whose exact
   gradient is 0, at the adjacency weight's scale).
7. The training main path: ``entry.train_entry()``, the bfloat16 SCG at full
   width, 832x1344, batch 8, ``frozen_stages=1``, three losses, two-group
   AdamW at the reference lr; one warm-up step, then ``TRAIN_STEPS`` steps
   with the counts set to 0 just before.  It checks that every loss is
   finite and every step applied, that the kernel and its adjoint kernel
   ran once per step, that the FrozenBN kernels ran at every site forward
   and at each ``layer2-4`` site backward (53 + 42 a step), that the stem
   and ``layer1`` are bit-for-bit unchanged and that both optimizer groups
   moved; prints peak memory, the losses, and what the NaN guard's host
   read costs.  The step's rate and the device's idle share are the
   benchmark cell ``scg_r50.train_b8``'s (``python3 -m hoibench.run``).
8. The CLI path: synthetic HICO-DET written by ``data.synthetic`` (16
   landscape training images at 480x640, resized to 800x1066 in the 832x1344
   canvas; 8 portrait test images at 640x480), then
   ``tools.train_hicodet.main`` at full width in float32 (TF32 off), batch
   8, 2 epochs with validation on the portrait split, 4 loader workers, with
   the counts set to 0 just before: it checks two ``Epoch:`` lines, finite
   losses, ``ckpt_01.pt`` and ``ckpt_02.pt``, one kernel launch per train
   step and per validation batch and one adjoint kernel launch per train
   step; resumes
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
   filtered ranks of the first 128 test triples, under the same tables,
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
11. Data parallel on the one card: ``torch.distributed.run --standalone
    --nproc-per-node 1`` starts this script's ``--ddp-worker`` mode, which
    runs ``train_hicodet.main`` (``--synthetic``, one 4-step epoch, batch 2)
    and ``train_kge.main`` (``--example transe_fb15k237 --data-parallel``,
    one epoch on the FB15K237-size KG) in a process group of one over
    NCCL; each is held against the same worker started plainly (losses
    and parameters at rtol ``DDP_TOL``; both workers take cuDNN's and
    PyTorch's deterministic kernels), with the step ms of each, the HOI
    step's all-reduce timed alone, and the launches of the kernel and of its
    adjoint (one a step).  Parity across two ranks is the CPU test's
    (``tests/test_torch_port_ddp.py``): the smoke has one card.
12. Stage-1 detection at full width: a seeded random torchvision-layout
    ``fasterrcnn_resnet50_fpn`` ``state_dict`` (91 classes) saved as a
    ``.pt``, then ``preprocess_detections.main`` over synthetic HICO-DET
    (8 landscape 120x160 images, the ones ``train_hicodet --synthetic``
    trains on, and 4 portrait 640x480), float32, ``--score-thresh
    0.001`` (random weights give class probabilities near 1/91): images/s,
    one kernel launch an image and one FrozenBN forward launch a site (53
    an image).  For one image of each canvas: ms of each stage
    (backbone+FPN, RPN with its NMS, RoI heads, class NMS), NMS steps, one
    traced image's device ops and idle share; the kernel against
    its plain version on the real ``[1, 1000, 4]`` proposals (random weights
    put them all on P2) and on the same proposals with a quarter rescaled
    onto each of P2..P5, each timed cold and warm against its byte bound;
    the detector on the card against the
    CPU, stage by stage: the candidate pools held first, then each flip of
    an NMS or top-k decision verified as a tie (``selection_flips``), and a
    box moved 0.5 px on the card must be refused.  Then ``train_hicodet --synthetic`` reads the cached JSON files
    for one 2-step epoch.  The kernels line gains ``launches_frcnn``,
    ``us_frcnn_cold`` and ``share_of_bound_frcnn`` (the landscape canvas's
    real, P2-only proposals) and ``us_frcnn_spread_cold`` and
    ``share_of_bound_frcnn_spread`` (the same spread over P2..P5).

13. The trainable stage-1 detectors at full width (80 HICO classes), float32
    with TF32 off, seeded random weights, on synthetic HICO-DET resized into
    the 832x1344 canvas: ``FPNDetector`` (256 channels, 9 anchors a cell on
    P3-P5, 206 388 anchors an image) card against CPU on one image (logits
    and deltas within ``S1_LOGIT_TOL`` of their largest, losses at rtol
    ``S1_LOSS_RTOL``, every gradient within ``S1_GRAD_TOL`` of its largest
    or within ``S1_GRAD_FLOAT64_TOL`` of a float64 CPU run,
    ``decode_detections`` through ``selection_flips`` with a planted 0.5 px
    offset refused), its train step (``train_detector``'s
    ``build_fpn_step``, AdamW) at batch 4 timed with one traced step, and
    ``decode_detections`` on one image; AdaMixer (100 queries, 6 stages,
    content 256, 4 groups, 32/128 points, FFN 2048) trained for
    ``S1_ADAMIXER_STEPS`` steps, untimed (its rate is the benchmark cell
    ``adamixer_r50.train_b4``'s), each launching the sampling kernels once
    each way a stage;
    card against CPU at init and with the trained weights (outputs within
    ``S1_ADAMIXER_TOL``, the set loss on the CPU's assignments fed to both,
    and in float64 the pyramids within ``S1_PYR64_TOL``, then the backbone's
    gradients at init and the pyramid's and the decoder's after training
    within ``S1_GRAD64_TOL``); a seeded
    random facebookresearch-layout DETR-R50 ``.pt`` through
    ``preprocess_detections --detector detr`` over 8 landscape and 4
    portrait images (images/s) and one image card against CPU
    (``S1_DETR_TOL``); the AdaMixer chain ``train_detector --synthetic
    --arch adamixer`` -> ``preprocess_detections --detector adamixer`` ->
    one ``train_hicodet --synthetic`` epoch on those caches, whose RoIAlign
    launches the kernels line reports as ``launches_adamixer_chain``.
    Then bfloat16 (13e): ``bench.py --stage1``'s model, ``DETR(dtype=
    torch.bfloat16)`` (91 classes, 6+6 layers, 100 queries, seeded weights)
    at 832x1344, batch 8 (its rate is the benchmark cell
    ``detr_r50.detect_b8``'s); its encoder's input float32; the batch's
    eight images card against CPU in bfloat16, each output of each image
    within ``S1_BF16_FACTOR`` x the card's own bfloat16-against-float32 gap
    on it, which the float32 model on the card gives.

14. The user and measurement tools on the card, on what phases 8, 9 and 12
    left (``keep``; run alone, :func:`tool_inputs` makes stand-ins): (a)
    ``extract_roi_features`` over phase 8's 16 training images (480x640 in
    the 832x1344 canvas, batch 4, float32): one ``.npz`` an image, one
    kernel launch a batch (``launches_extract``), the first batch against a
    CPU run with the same seeded backbone (boxes, labels, scores and
    ``n_h`` equal, features within ``TOOLS_FEATURE_TOL`` of the largest),
    and the kernel against its plain version on the tool's boxes; (b)
    ``demo`` with phase 8's ``ckpt_02.pt`` on a portrait test image
    (1344x832): one launch (``launches_demo``), pairs, verbs and objects
    equal to a CPU run and scores within 1e-4; (c) ``visualise_detections``
    on phase 12's Faster R-CNN caches, the kept boxes equal to ``--cpu``'s;
    (d) ``learning_curve.parse_log`` on phase 8's ``train_hicodet`` log;
    (e) ``perf_report`` (bf16, batch 8, 832x1344: img/s, TFLOP a step, MFU,
    ``first_call_seconds``, one launch a forward: ``launches_perf_report``)
    beside phase 4; (f) ``stage_profile`` (every part, batch 8), the
    kernel against its plain version on its head inputs; (g) ``bench_io
    --train`` over phase 8's images, beside phase 8's train img/s; (h) the
    host tools once (``hicodet_split``, ``navigator`` on a scripted stdin,
    ``generate_html_page``, ``kge_results_table`` on phase 9's rows,
    ``kge_relation_stats`` on its WN18RR-size KG, ``visualise_and_cache`` on
    the ``.mat`` files ``cache_results --dataset hicodet`` writes with
    ``ckpt_02.pt``, ``text_label``).  Without matplotlib the overlays and
    plots are left out and ``"matplotlib": false`` is printed.
15. The FrozenBatchNorm kernels (``ops/frozen_bn_cuda.py``) over the
    ResNet-50 body's 53 sites at the detect shape (bf16, 832x1344, batch 8;
    :func:`frozen_bn_sites`): each site's forward kernel, then its backward
    kernel, launched alone after an L2 flush and queued behind a device
    sleep, timed by CUDA events, summed over the sites; the plain eager
    composition (``frozen_bn_plain``, ``frozen_bn_backward_plain``) the same
    way; each beside its byte bound.  First, at every site, the output and
    both gradients must equal the plain composition's (``torch.equal``).
    The kernels line's FrozenBN entry gains the launch counts of phases 7
    and 12 (a train step, an image).  Alone: ``python3 -c "import
    chip_smoke as c; c.phase_frozen_bn()"``.
16. AdaMixer's sampling kernels (``ops/adamixer_sample_cuda.py``) at the
    training cell's shapes (batch 4, 100 queries x 4 groups x 32 points, 64
    channels a group) on the four levels of each canvas, the points drawn as
    a stage draws them, some past a border (:func:`sample_inputs`): the
    forward kernel ``torch.equal`` to the eager route in float32 and
    float64, the adjoint kernel within ``SAMPLE_ADJOINT_TOL`` of autograd
    through the eager route; each kernel alone after an L2 flush (device
    time from a trace) against its byte bound (:func:`sample_bytes`: the
    distinct tap cells counted from the points), beside the plain versions;
    the launch counters; one decoder forward and backward at batch 4, one
    launch each way a stage.  The kernels line's sampling entry gains the
    launches a step of phase 13b's train steps, the main path's.  Alone:
    ``python3 -c "import chip_smoke as c; c.phase_adamixer_sample()"``.

It prints the train step's, the CLI path's, the KGE, the V-COCO/TransH, the
data-parallel, the detection, the detectors', the tools', the FrozenBN
kernels' and the sampling kernels' JSON lines, the
kernels' JSON line (the forward kernel and its adjoint), the card, then
``{"ok": true, "device": ...}`` last.  Without a
CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from hoibench.roofline import adjoint_bytes, adjoint_ops, roi_forward_bound_s, sample_cells

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


@functools.cache
def l2_flush_buffer() -> torch.Tensor:
    """256 MB on the card, five times the 50 MB L2: zeroing it evicts the L2."""
    return torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")


def cold_ms(fn, reps: int = 5, flush: bool = True) -> float:
    """Median device ms of ``fn``, after one call to warm it up: each call is
    queued behind a ~10 ms device sleep, so the host has issued all of it
    before the device starts and the events measure the device alone
    (``fn`` must not synchronise); with ``flush``, the L2 is flushed before
    each call, so that ``fn`` finds its inputs in HBM."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        if flush:
            l2_flush_buffer().zero_()
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def build_logged(kernel, tag: str) -> None:
    """Build ``kernel``'s library (``ops/nvcc.py``), then log the build's
    time and the compiler's register and spill lines."""
    kernel.build()
    log(f"[{tag}] built {kernel.source.name} in {kernel.build_seconds:.2f} s")
    for line in kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[{tag} build] {line.strip()}")


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


def grid_shapes(boxes, hw):
    """Level, distinct sample rows and distinct sample columns of each box
    (``hoibench.roofline.sample_cells``, over maps of sizes ``hw``)."""
    levels, per_level = sample_cells(boxes, hw)
    rows, cols = torch.zeros_like(levels), torch.zeros_like(levels)
    for l, cells in enumerate(per_level):
        for dst, idx in zip((rows, cols), cells):
            srt = idx.sort(-1).values
            n = 1 + (srt[..., 1:] != srt[..., :-1]).sum(-1)
            dst.copy_(torch.where(levels == l, n.to(dst.dtype), dst))
    return levels, rows, cols


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


def time_kernel(main_boxes):
    """Times on the main path's inputs (bf16, C=256, 832x1344, batch 8)."""
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

    # The same number of items, each a 2x2-cell padding slot: the kernel's
    # cost that does not grow with the cells it reads.
    pad = torch.zeros_like(main_boxes)
    pad_levels = fpn_level_assignment(pad).contiguous()
    pad_ms = graph_ms([(lambda m: lambda: roi_align_cuda.launch(m, pad, pad_levels, out))(
        copies[i % 3]) for i in range(30)], iters=20)

    def call(m):
        return lambda: roi_align_cuda.launch(m, main_boxes, levels, out)

    cold, cold6 = [graph_ms([call(copies[i % n]) for i in range(10 * n)], iters=20) for n in (3, 6)]
    warm = graph_ms([call(maps)] * 20, iters=20)
    del copies
    call_ms = graph_ms([lambda: roi_align_cuda(maps, main_boxes)] * 20, iters=20)
    eager_ms = cuda_ms(lambda: roi_align_cuda(maps, main_boxes), iters=200)
    plain_ms = cuda_ms(lambda: multiscale_roi_align(maps, main_boxes), iters=10)
    bound_ms = roi_forward_bound_s([m.shape for m in maps], main_boxes, 2, HBM_BYTES_PER_S,
                                   FP32_FLOPS_PER_S) * 1e3
    log(f"[kernel] roi_align bf16 B={BATCH} N={main_boxes.shape[1]} C=256, pyramid "
        f"{pyramid_mb:.1f} MB: kernel alone, cold L2 {cold:.5f} ms (3 pyramid copies; "
        f"{cold6:.5f} with 6), warm L2 {warm:.5f} ms (same inputs), both CUDA graph; "
        f"padding slots only {pad_ms:.5f} ms (cold); "
        f"per call with level assignment {call_ms:.5f} ms (CUDA graph, warm); "
        f"eager call {eager_ms:.5f} ms; plain {plain_ms:.4f} ms; bound {bound_ms:.5f} ms: "
        f"cold time at {bound_ms / cold:.1%} of the bound")
    return dict(ms=cold, cold_ms=cold, cold6_ms=cold6, warm_ms=warm, pad_ms=pad_ms,
                call_ms=call_ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_share=bound_ms / cold, library_ms=None)


def phase_kernel(main_boxes):
    err_bf16, err_fp32 = check_kernel(main_boxes)
    return dict(name="roi_align", route="cuda", source="skghoi_torch/csrc/roi_align.cu",
                replaces="skghoi_tpu/ops/pallas_roi_align.py:213",
                max_abs_err=err_bf16, max_abs_err_fp32=err_fp32, **time_kernel(main_boxes))


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
    return launches, BATCH * requests / total


def _map_grads(fn, maps, cot):
    """Gradients of ``sum(fn(maps) * cot)`` with respect to each map."""
    leaves = [m.detach().requires_grad_(True) for m in maps]
    (fn(leaves).float() * cot.float()).sum().backward()
    return [m.grad for m in leaves]


def adjoint_bounds(shapes, n_boxes, elem):
    """Least time for the adjoint: (bytes ms, GEMM-operation ms, bytes, ops).
    Bytes: ``hoibench.roofline.adjoint_bytes``.  Operations: the two GEMMs
    of each level as the plain version formulates them (every box at every
    level, the other levels' boxes masked to zero), at the float32 rate
    outside the tensor cores (TF32 is off)."""
    bsz, c = shapes[0][0], shapes[0][3]
    n_bytes = adjoint_bytes(shapes, n_boxes, elem)
    ops = sum(2 * bsz * n_boxes * 7 * w * 7 * c + 2 * bsz * h * w * c * 7 * n_boxes
              for _, h, w, _ in shapes)
    return n_bytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS_PER_S * 1e3, n_bytes, ops


def adjoint_cases(main_boxes):
    """(name, canvas, C, [B, N, 4] boxes) on which phase 5 holds the adjoint:
    phase 2's cases (600 random boxes an image at C=64), the main path's boxes
    at C=136 (a ragged last channel slice) and 64, ``pile`` (100 boxes an
    image inside one 8x8-cell tile of P2, duplicates among them), and the
    portrait pyramid."""
    dev = main_boxes.device
    cases = {name: boxes for name, _, boxes in kernel_cases(main_boxes)}
    g = torch.Generator(device=dev).manual_seed(3)
    xy = 416.0 + torch.rand(BATCH, 100, 2, generator=g, device=dev) * 10.0  # P2 cells 104-111
    pile = torch.cat([xy, xy + 1.0 + torch.rand(BATCH, 100, 2, generator=g, device=dev) * 14.0], -1)
    pile[:, 50:] = pile[:, :50]
    swap = [1, 0, 3, 2]
    return ([("main", CANVAS, 256, main_boxes), ("main", CANVAS, 136, main_boxes),
             ("main", CANVAS, 64, main_boxes)]
            + [(name, CANVAS, 64 if name == "many" else 256, cases[name])
               for name in ("edge", "grid28", "map_edges", "padding", "b1n1", "many")]
            + [("pile", CANVAS, 256, pile),
               ("main_portrait", PORTRAIT, 256, main_boxes[..., swap].contiguous()),
               ("map_edges_portrait", PORTRAIT, 256, cases["map_edges"][..., swap].contiguous())])


def check_adjoint(main_boxes):
    """``RoIAlignFunction``'s map gradients (the adjoint kernel) against
    autograd through the plain gather version on every case of
    :func:`adjoint_cases`, float32 and bfloat16; the kernel against
    ``roi_align_adjoint`` on the same inputs; and two calls bit for bit.
    Returns the largest errors."""
    from skghoi_torch.ops.roi_align import multiscale_roi_align, roi_align_adjoint
    from skghoi_torch.ops.roi_align_cuda import RoIAlignFunction

    g = torch.Generator(device="cuda").manual_seed(7)
    errs = {}
    for name, canvas, c, boxes in adjoint_cases(main_boxes):
        bsz = boxes.shape[0]
        maps32 = [torch.randn(bsz, canvas[0] // s, canvas[1] // s, c, device="cuda", generator=g)
                  for s in (4, 8, 16, 32)]
        maps16 = [m.bfloat16() for m in maps32]
        cot = torch.randn(*boxes.shape[:2], 7, 7, c, device="cuda", generator=g)
        plain = lambda m: multiscale_roi_align(m, boxes)  # noqa: E731
        node = lambda m: RoIAlignFunction.apply(boxes, *m)  # noqa: E731
        ref = _map_grads(plain, maps32, cot)
        ref_abs = _map_grads(plain, maps32, cot.abs())
        got32, got16 = _map_grads(node, maps32, cot), _map_grads(node, maps16, cot.bfloat16())
        same = all(torch.equal(a, b) for a, b in zip(got32 + got16, _map_grads(node, maps32, cot)
                                                      + _map_grads(node, maps16, cot.bfloat16())))
        shapes = [tuple(m.shape) for m in maps32]
        gemm32 = roi_align_adjoint(shapes, torch.float32, boxes, cot)
        gemm16 = roi_align_adjoint(shapes, torch.bfloat16, boxes, cot.bfloat16())
        tag = f"{name} C={c} {canvas[0]}x{canvas[1]} boxes {tuple(boxes.shape)}"
        for l, (r, ra, a, b, p32, p16) in enumerate(zip(ref, ref_abs, got32, got16, gemm32, gemm16)):
            if a.dtype != torch.float32 or b.dtype != torch.bfloat16 or a.shape != r.shape:
                raise AssertionError(f"adjoint {tag} level {l}: {a.dtype} {b.dtype} {tuple(a.shape)}")
            ok32 = torch.allclose(a, r, **ADJOINT_TOL)
            excess = ((b.float() - r).abs() - 2.0 ** -8 * (r.abs() + ra)).max().item()
            direct = torch.allclose(a, p32, rtol=FP32_TOL, atol=FP32_TOL)
            e = dict(fp32=(a - r).abs().max().item(), bf16=(b.float() - r).abs().max().item(),
                     direct_fp32=(a - p32).abs().max().item(),
                     direct_bf16=(b.float() - p16.float()).abs().max().item())
            errs[(name, c, canvas, l)] = e
            log(f"[adjoint] {tag} P{l + 2}: fp32 max|kernel-plain| {e['fp32']:.3e} (rtol 1e-3, "
                f"atol 1e-4) {'ok' if ok32 else 'FAIL'}; bf16 max|kernel-plain fp32| "
                f"{e['bf16']:.3e}, largest excess over 2^-8 (|ref| + A|g|) {excess:.3e} "
                f"{'ok' if excess <= 0 else 'FAIL'}; against roi_align_adjoint fp32 "
                f"{e['direct_fp32']:.3e} (rtol=atol={FP32_TOL:g}) {'ok' if direct else 'FAIL'}, "
                f"bf16 {e['direct_bf16']:.3e}; max|ref| {r.abs().max().item():.3e}")
            if not ok32 or excess > 0 or not direct:
                raise AssertionError(f"RoIAlign adjoint kernel disagrees with the plain version "
                                     f"({tag}, level {l})")
        log(f"[adjoint] {tag}: two calls bit for bit {'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"RoIAlign adjoint kernel is not deterministic ({tag})")
        if name == "main" and c == 256 and not any(r.abs().max() > 0 for r in ref):
            raise AssertionError("adjoint: the reference gradient is 0; the check would be vacuous")
        del maps32, maps16, ref, ref_abs, got32, got16, gemm32, gemm16
    main = [e for (n, c, cv, _), e in errs.items() if (n, c, cv) == ("main", 256, CANVAS)]
    log(f"[adjoint] all {len(errs)} (case, level) pairs agree; largest fp32 error against autograd "
        f"{max(e['fp32'] for e in errs.values()):.3e}, against roi_align_adjoint "
        f"{max(e['direct_fp32'] for e in errs.values()):.3e}")
    return dict(max_abs_err=max(e["direct_bf16"] for e in main),
                max_abs_err_fp32=max(e["direct_fp32"] for e in errs.values()),
                max_abs_err_autograd_fp32=max(e["fp32"] for e in errs.values()),
                max_abs_err_autograd_bf16=max(e["bf16"] for e in errs.values()))


def _launches_per_call(fn):
    """Device launches one call of ``fn`` issues (torch.profiler's host-side
    launch calls)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in LAUNCH_CALLS), prof


def time_adjoint(main_boxes):
    """The adjoint kernel alone on the main path's inputs (bf16, C=256,
    832x1344, batch 8): cold L2 (calls rotate over three copies of the
    cotangent and gradients, as phase 2 does), warm, both in a CUDA graph;
    queued behind a device sleep; eager.  Beside it the GEMM route
    (``roi_align_adjoint``, cuBLAS) and autograd's backward through the plain
    gather version, on the same inputs."""
    from skghoi_torch.ops.roi_align import (fpn_level_assignment, multiscale_roi_align,
                                            roi_align_adjoint)
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda

    g = torch.Generator(device="cuda").manual_seed(8)
    shapes = [(BATCH, CANVAS[0] // s, CANVAS[1] // s, 256) for s in (4, 8, 16, 32)]
    levels = fpn_level_assignment(main_boxes).contiguous()
    cot = torch.randn(*main_boxes.shape[:2], 7, 7, 256, device="cuda", generator=g).bfloat16()
    copies = [([torch.empty(s, dtype=torch.bfloat16, device="cuda") for s in shapes],
               cot if i == 0 else cot.clone()) for i in range(3)]
    grads = copies[0][0]

    def call(grads, cot):
        return lambda: roi_align_cuda.adjoint(grads, main_boxes, levels, cot)

    cold = graph_ms([call(*copies[i % 3]) for i in range(30)], iters=20)
    warm = graph_ms([call(grads, cot)] * 20, iters=20)
    device_ms = cold_ms(call(grads, cot), flush=False)
    eager_ms = cuda_ms(call(grads, cot), iters=50)
    launches, _ = _launches_per_call(call(grads, cot))
    del copies

    gemm = lambda: roi_align_adjoint(shapes, torch.bfloat16, main_boxes, cot)  # noqa: E731
    gemm_device_ms = cold_ms(gemm, flush=False)
    gemm_eager_ms = cuda_ms(gemm, iters=20)
    gemm_launches, prof = _launches_per_call(gemm)
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=8))

    leaves = [torch.randn(s, device="cuda", generator=g).bfloat16().requires_grad_(True)
              for s in shapes]
    out = multiscale_roi_align(leaves, main_boxes)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True), iters=5,
                       warmup=1)
    del out, leaves

    bytes_ms, gemm_ops_ms, n_bytes, gemm_ops = adjoint_bounds(shapes, main_boxes.shape[1], 2)
    ops = adjoint_ops(shapes, main_boxes)
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    bound_ms, bound_by = max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"[adjoint] kernel bf16 B={BATCH} N={main_boxes.shape[1]} C=256 {CANVAS[0]}x{CANVAS[1]} "
        f"pyramid: alone, cold L2 {cold:.5f} ms (3 copies), warm L2 {warm:.5f} ms, both "
        f"CUDA graph; queued behind a sleep {device_ms:.5f} ms; eager {eager_ms:.5f} ms; "
        f"{launches} device launches a call; bound {bound_ms:.5f} ms by {bound_by} "
        f"({n_bytes / 1e6:.1f} MB; {ops / 1e6:.1f} MFLOP of multiply-adds, {ops_ms:.5f} ms): cold "
        f"time at {bound_ms / cold:.1%} of the bound, queued {bound_ms / device_ms:.1%}")
    log(f"[adjoint] GEMM route (roi_align_adjoint, cuBLAS), same inputs: {gemm_device_ms:.4f} ms "
        f"of device time (queued behind a sleep), {gemm_eager_ms:.4f} ms a call eager, "
        f"{gemm_launches} device launches a call, {gemm_ops / 1e9:.1f} GFLOP (bound "
        f"{gemm_ops_ms:.4f} ms at the fp32 rate); the kernel's queued time is "
        f"{device_ms / gemm_device_ms:.1%} of it. Autograd through the plain gather version, "
        f"backward alone: {plain_ms:.4f} ms a call")
    return dict(ms=cold, cold_ms=cold, warm_ms=warm, device_ms=device_ms,
                eager_ms=eager_ms, launches_per_call=launches, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes_bound_ms=bytes_ms,
                bound_share=bound_ms / cold, library_ms=gemm_device_ms,
                library="roi_align_adjoint: batched torch.matmul (cuBLAS), the GEMM route",
                library_eager_ms=gemm_eager_ms, library_launches_per_call=gemm_launches,
                library_ops_bound_ms=gemm_ops_ms)


def phase_adjoint(main_boxes):
    """Phase 5: the adjoint kernel against its plain versions, then timed."""
    return dict(name="roi_align_adjoint", route="cuda", source="skghoi_torch/csrc/roi_align.cu",
                replaces="skghoi_tpu/ops/pallas_roi_align.py:222", **check_adjoint(main_boxes),
                **time_adjoint(main_boxes))


def frozen_bn_sites(batch: int = BATCH, canvas=CANVAS, dtype=torch.bfloat16):
    """The ResNet-50 body's FrozenBatchNorm sites in the order
    ``ResNet50.forward`` calls them on a ``[batch, 3, *canvas]`` input, from a
    forward on meta tensors: ``(name, shape, residual, relu)`` each, ``name``
    the module's (``layer2-4`` train in the SCG, ``frozen_stages=1``)."""
    from skghoi_torch.models.resnet import FrozenBatchNorm, ResNet50

    with torch.device("meta"):
        model = ResNet50(dtype=dtype)
    sites = []

    def recorder(name):
        def hook(module, args, kwargs):
            bound = dict(zip(("x", "residual", "relu"), args), **kwargs)
            sites.append((name, tuple(bound["x"].shape), bound.get("residual") is not None,
                          bool(bound.get("relu", False))))
        return hook

    for name, m in model.named_modules():
        if isinstance(m, FrozenBatchNorm):
            m.register_forward_pre_hook(recorder(name), with_kwargs=True)
    model(torch.empty(batch, 3, *canvas, device="meta"))
    return sites


def frozen_bn_launches_per_step():
    """FrozenBN kernel launches an SCG train step makes (``frozen_stages=1``):
    one forward at every site, one backward at each site of the trainable
    ``layer2-4``."""
    sites = frozen_bn_sites()
    return len(sites), sum(n.startswith(("layer2.", "layer3.", "layer4.")) for n, *_ in sites)


def frozen_bn_bytes(sites, elem: int = 2, backward: bool = False) -> int:
    """Bytes the sites must move, each tensor read or written once: forward,
    the input and output (and the residual); backward, the output's gradient
    and the input's (and the output, where the ReLU masks, and the
    residual's gradient)."""
    total = 0
    for _, shape, residual, relu in sites:
        tensors = 2 + (residual and relu) + relu if backward else 2 + residual
        total += tensors * math.prod(shape) * elem
    return total


def phase_frozen_bn():
    """Phase 15: the FrozenBatchNorm kernels over the body's 53 sites at the
    detect shape, forward and backward, against their byte bounds and the
    plain composition (module docstring)."""
    from skghoi_torch.ops.frozen_bn_cuda import (frozen_bn_backward_plain, frozen_bn_cuda,
                                                 frozen_bn_plain)

    build_logged(frozen_bn_cuda, "frozen_bn")
    sites = frozen_bn_sites()
    g = torch.Generator(device="cuda").manual_seed(15)
    ms = dict(fwd=0.0, bwd=0.0, plain_fwd=0.0, plain_bwd=0.0)
    mismatches = []
    with torch.no_grad():
        for name, shape, residual, relu in sites:
            x = torch.randn(shape, generator=g, device="cuda").bfloat16().contiguous(
                memory_format=torch.channels_last)
            res = torch.randn_like(x).contiguous(memory_format=torch.channels_last) \
                if residual else None
            inv = torch.rand(shape[1], generator=g, device="cuda").add_(0.5).bfloat16()
            shift = torch.randn(shape[1], generator=g, device="cuda").mul_(0.1).bfloat16()
            y = frozen_bn_cuda(x, inv, shift, res, relu)
            gy = torch.randn_like(x).contiguous(memory_format=torch.channels_last)
            out = y if relu else None
            got = frozen_bn_cuda.backward(gy, inv, out, residual)
            want = frozen_bn_backward_plain(gy, inv, out, residual)
            for what, a, b in (("output", y, frozen_bn_plain(x, inv, shift, res, relu)),
                               ("input gradient", got[0], want[0]),
                               ("residual gradient", got[1], want[1])):
                if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                    mismatches.append(f"{name} {shape} {what}")
            del got, want
            ms["fwd"] += cold_ms(lambda: frozen_bn_cuda(x, inv, shift, res, relu))
            ms["plain_fwd"] += cold_ms(lambda: frozen_bn_plain(x, inv, shift, res, relu))
            ms["bwd"] += cold_ms(lambda: frozen_bn_cuda.backward(gy, inv, out, residual))
            ms["plain_bwd"] += cold_ms(lambda: frozen_bn_backward_plain(gy, inv, out, residual))
            del x, res, y, gy, out
    if mismatches:
        raise AssertionError(f"frozen_bn: the kernels differ from the plain composition at "
                             f"{len(mismatches)} places: {mismatches}")
    fwd_bytes, bwd_bytes = frozen_bn_bytes(sites), frozen_bn_bytes(sites, backward=True)
    bound = dict(fwd=fwd_bytes / HBM_BYTES_PER_S * 1e3, bwd=bwd_bytes / HBM_BYTES_PER_S * 1e3)
    result = dict(name="frozen_bn", route="cuda", source="skghoi_torch/csrc/frozen_bn.cu",
                  replaces="none (XLA fuses FrozenBN, residual add and ReLU into the convolution "
                           "on the TPU)", sites=len(sites), dtype="bfloat16",
                  shape=f"{BATCH}x{CANVAS[0]}x{CANVAS[1]}", fwd_bytes=fwd_bytes,
                  bwd_bytes=bwd_bytes,
                  **{f"{k}_ms": v for k, v in ms.items()},
                  **{f"{k}_bound_ms": v for k, v in bound.items()},
                  fwd_share=bound["fwd"] / ms["fwd"], bwd_share=bound["bwd"] / ms["bwd"])
    log(f"[frozen_bn] {len(sites)} sites: output, input gradient and residual gradient equal "
        f"the plain composition's (torch.equal)")
    log(f"[frozen_bn] {len(sites)} sites, bf16 {BATCH}x{CANVAS[0]}x{CANVAS[1]}, each alone after "
        f"an L2 flush: forward {ms['fwd']:.4f} ms (bound {bound['fwd']:.4f} ms, "
        f"{fwd_bytes / 1e9:.3f} GB: {result['fwd_share']:.1%}), plain {ms['plain_fwd']:.4f} ms; "
        f"backward {ms['bwd']:.4f} ms (bound {bound['bwd']:.4f} ms, {bwd_bytes / 1e9:.3f} GB: "
        f"{result['bwd_share']:.1%}), plain {ms['plain_bwd']:.4f} ms; card {card_line()}")
    print(json.dumps({"frozen_bn": result}), flush=True)
    return result


# phase 16: AdaMixer's sampling kernels at the training cell's shapes
# (hoibench adamixer_r50.train_b4): batch 4, 100 queries x 4 groups x 32
# points, 64 channels a group, the four levels of each canvas.
SAMPLE_QUERIES, SAMPLE_GROUPS, SAMPLE_POINTS, SAMPLE_CHANNELS = 100, 4, 32, 64
# The adjoint's atomics and reductions sum in another order than autograd
# through the eager route: each gradient within this share of its largest.
SAMPLE_ADJOINT_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def sample_inputs(canvas, dtype, seed):
    """Levels ``[(feat [B, G, H*W, c], H, W)]``, points ``[B, G, M, 3]`` and
    level weights ``[B, G, M, 4]`` on the card, the points drawn as a stage
    draws them: boxes (centres over the canvas and a twentieth beyond each
    side, sides 2^4-2^9.5 px, aspect 1/4-4) and each box's
    ``_initial_offsets`` grid moved by N(0, 0.3) box sides (z by N(0, 1)),
    so some points fall past a border; then laid out as ``sample_groups``
    lays them out."""
    from skghoi_torch.detect.adamixer import _initial_offsets, _level_logs, _wh

    g = torch.Generator(device="cuda").manual_seed(seed)
    b, n, gr, p = S1_BATCH, SAMPLE_QUERIES, SAMPLE_GROUPS, SAMPLE_POINTS

    def uniform(lo, hi, *shape):
        return torch.rand(*shape, generator=g, device="cuda", dtype=torch.float64) * (hi - lo) + lo

    h, w = canvas
    levels = []
    for stride in (4, 8, 16, 32):
        lh, lw = h // stride, w // stride
        feat = torch.randn(b, gr, lh * lw, SAMPLE_CHANNELS, generator=g, device="cuda",
                           dtype=torch.float64)
        levels.append((feat.to(dtype), lh, lw))
    x, y = uniform(-0.05 * w, 1.05 * w, b, n), uniform(-0.05 * h, 1.05 * h, b, n)
    z, r = uniform(4.0, 9.5, b, n), uniform(-2.0, 2.0, b, n)
    bw, bh = _wh(z, r)
    grid = torch.from_numpy(_initial_offsets(gr, p)).to("cuda", torch.float64).view(gr, p, 3)
    off = grid + torch.randn(b, n, gr, p, 3, generator=g, device="cuda",
                             dtype=torch.float64) * torch.tensor([0.3, 0.3, 1.0], device="cuda",
                                                                 dtype=torch.float64)
    base = torch.stack([x, y, z], -1)[:, :, None, None, :]
    scale = torch.stack([bw, bh, torch.ones_like(z)], -1)[:, :, None, None, :]
    points = (base + off * scale).to(dtype).permute(0, 2, 1, 3, 4).reshape(b, gr, n * p, 3)
    points = points.contiguous()
    logs = _level_logs(points.device, dtype)
    wts = torch.softmax(-((points[..., 2:] - logs) ** 2) / 2.0, dim=-1)
    return levels, points, wts


def sample_bytes(levels, points):
    """Bytes the sampling must move, each once, and the distinct tap cells:
    forward, the points, the weights, the output and each distinct tap cell
    of every level; adjoint, the points, the weights and the output's
    gradient read, the points' and the weights' gradients written, each
    distinct tap cell read and its gradient written."""
    from skghoi_torch.detect.adamixer import LEVEL_STRIDES, _taps

    elem, c = points.element_size(), levels[0][0].shape[-1]
    bg = torch.arange(points.shape[0] * points.shape[1], device=points.device).view(
        *points.shape[:2], 1)
    touched = 0
    for (feat, h, w), stride in zip(levels, LEVEL_STRIDES):
        idx, _, _ = _taps(h, w, points[..., 0] / stride, points[..., 1] / stride)
        touched += torch.unique(torch.cat([(bg * (h * w) + i).flatten() for i in idx])).numel()
    per_point = points.shape[-1] + len(levels)  # x, y, z and the level weights
    small = points.shape[0] * points.shape[1] * points.shape[2] * per_point * elem
    out = points.shape[0] * points.shape[1] * points.shape[2] * c * elem
    return dict(fwd=small + out + touched * c * elem,
                bwd=2 * small + out + 2 * touched * c * elem, cells=touched)


def _eager_graph(levels, points, wts):
    """The eager route's output and the leaves it was sampled from (copies of
    ``points``, ``wts`` and the levels that require their gradient)."""
    from skghoi_torch.detect.adamixer import _sample_levels

    leaves = [t.detach().requires_grad_(True) for t in (points, wts, *(f for f, _, _ in levels))]
    with torch.enable_grad():
        out = _sample_levels([(f, h, w) for f, (_, h, w) in zip(leaves[2:], levels)], *leaves[:2])
    return out, leaves


def sample_adjoint_autograd(grad_out, levels, points, wts):
    """Autograd through the eager route, the adjoint kernel's reference: from
    the output's gradient ``[B, G, M, c]``, the gradients of ``points`` (z's
    0: the level weights carry it), of ``wts`` and of each level's map."""
    out, leaves = _eager_graph(levels, points, wts)
    grad_points, grad_wts, *grads = torch.autograd.grad(out, leaves, grad_out)
    return grad_points, grad_wts, grads


def eager_backward(grad_out, levels, points, wts):
    """A call of autograd's backward through the eager route's graph, built
    once here (to time the backward alone)."""
    out, leaves = _eager_graph(levels, points, wts)
    return lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True)


def phase_adamixer_sample():
    """Phase 16: AdaMixer's sampling kernels (``ops/adamixer_sample_cuda.py``)
    at the training cell's shapes on both canvases: the forward ``torch.equal``
    to the eager route in float32 and float64, the adjoint within
    ``SAMPLE_ADJOINT_TOL`` of autograd through it; each kernel alone after
    an L2 flush (its device time in a trace) against its byte bound, beside
    the plain versions; the launch counters, and one decoder forward and
    backward at batch 4 launching each kernel once a stage.  Alone:
    ``python3 -c "import chip_smoke as c; c.phase_adamixer_sample()"``."""
    from torch.profiler import ProfilerActivity, profile

    from skghoi_torch.detect.adamixer import INV_STRIDES, AdaMixerDecoder, _sample_levels
    from skghoi_torch.ops.adamixer_sample_cuda import sample_cuda

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_logged(sample_cuda, "adamixer_sample")

    def kernel_ms(fn, pattern, reps=5):
        """Mean device ms of the kernel named ``pattern`` over ``reps`` calls
        of ``fn``, each after an L2 flush (from a trace: the adjoint's zero
        fill is not the kernel's)."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                l2_flush_buffer().zero_()
                fn()
            torch.cuda.synchronize()
        rows = [e for e in device_events(prof.key_averages()) if pattern in e.key]
        if sum(e.count for e in rows) != reps:
            raise AssertionError(f"adamixer_sample: {pattern} ran {[e.count for e in rows]} "
                                 f"times in {reps} calls")
        return sum(e.self_device_time_total for e in rows) / 1e3 / reps

    before = sample_cuda.launches, sample_cuda.backward_calls
    calls = [0, 0]
    result = dict(name="adamixer_sample", route="cuda",
                  source="skghoi_torch/csrc/adamixer_sample.cu",
                  replaces="none (XLA gathers in the JAX package: "
                           "skghoi_tpu/detect/adamixer.py::sample_3d)", canvases={})
    with torch.no_grad():
        for ci, canvas in enumerate((CANVAS, PORTRAIT)):
            key = f"{canvas[0]}x{canvas[1]}"
            res = result["canvases"][key] = {}
            for dtype in (torch.float32, torch.float64):
                levels, points, wts = sample_inputs(canvas, dtype, 16 + ci)
                feats, hw = [f for f, _, _ in levels], [(h, w) for _, h, w in levels]
                got = sample_cuda(feats, hw, INV_STRIDES, points, wts)
                want = _sample_levels(levels, points, wts)
                calls[0] += 1
                if not torch.equal(got, want):
                    bad = (got != want).sum().item()
                    raise AssertionError(f"adamixer_sample {key} {dtype}: the forward kernel "
                                         f"differs from the eager route at {bad} of "
                                         f"{got.numel()} values, by up to "
                                         f"{(got - want).abs().max().item():.3e}")
                gout = torch.randn(got.shape, generator=torch.Generator(device="cuda").manual_seed(
                    ci), device="cuda", dtype=torch.float64).to(dtype)
                kernel = sample_cuda.adjoint(gout, feats, hw, INV_STRIDES, points, wts)
                plain = sample_adjoint_autograd(gout, levels, points, wts)
                calls[1] += 1
                names = ["points", "wts"] + [f"level{i}" for i in range(len(levels))]
                rel = {n: ((a - b).abs().max() / b.abs().max()).item()
                       for n, a, b in zip(names, [*kernel[:2], *kernel[2]], [*plain[:2], *plain[2]])}
                if max(rel.values()) > SAMPLE_ADJOINT_TOL[dtype]:
                    raise AssertionError(f"adamixer_sample {key} {dtype}: the adjoint kernel "
                                         f"against autograd through the eager route {rel} (tol "
                                         f"{SAMPLE_ADJOINT_TOL[dtype]:g})")
                name = str(dtype).split(".")[-1]
                ix = points[..., 0:1] * torch.tensor(INV_STRIDES, device="cuda", dtype=dtype) - 0.5
                iy = points[..., 1:2] * torch.tensor(INV_STRIDES, device="cuda", dtype=dtype) - 0.5
                lim_w = torch.tensor([w - 1 for _, w in hw], device="cuda", dtype=dtype)
                lim_h = torch.tensor([h - 1 for h, _ in hw], device="cuda", dtype=dtype)
                clamped = ((ix < 0) | (ix >= lim_w) | (iy < 0) | (iy >= lim_h)).any(-1)
                res[name] = dict(forward_equal=True, adjoint_rel=rel,
                                 clamped_share=clamped.double().mean().item())
                if dtype == torch.float32:
                    nbytes = sample_bytes(levels, points)
                    bound = {k: nbytes[k] / HBM_BYTES_PER_S * 1e3 for k in ("fwd", "bwd")}
                    ms = dict(
                        fwd=kernel_ms(lambda: sample_cuda(feats, hw, INV_STRIDES, points, wts),
                                      "adamixer_sample_forward"),
                        bwd=kernel_ms(lambda: sample_cuda.adjoint(gout, feats, hw, INV_STRIDES,
                                                                  points, wts),
                                      "adamixer_sample_adjoint"),
                        plain_fwd=cold_ms(lambda: _sample_levels(levels, points, wts)),
                        plain_bwd=cold_ms(eager_backward(gout, levels, points, wts)))
                    calls[0] += 5  # kernel_ms's calls; cold_ms times the plain versions
                    calls[1] += 5
                    res.update(points=points.shape[0] * points.shape[1] * points.shape[2],
                               cells=nbytes["cells"], fwd_bytes=nbytes["fwd"],
                               bwd_bytes=nbytes["bwd"], **{f"{k}_ms": v for k, v in ms.items()},
                               **{f"{k}_bound_ms": v for k, v in bound.items()},
                               fwd_share=bound["fwd"] / ms["fwd"],
                               bwd_share=bound["bwd"] / ms["bwd"])
                del levels, points, wts, feats, got, want, gout, kernel, plain
                torch.cuda.empty_cache()
    counted = sample_cuda.launches - before[0], sample_cuda.backward_calls - before[1]
    if counted != tuple(calls):
        raise AssertionError(f"adamixer_sample: counters {counted}, calls {calls}")

    # One decoder forward and backward at batch 4 on a random pyramid: one
    # launch each way a stage.
    decoder = AdaMixerDecoder().cuda()
    g = torch.Generator(device="cuda").manual_seed(16)
    pyramid = [torch.randn(S1_BATCH, CANVAS[0] // s, CANVAS[1] // s, 256, generator=g,
                           device="cuda", requires_grad=True) for s in (4, 8, 16, 32)]
    before = sample_cuda.launches, sample_cuda.backward_calls
    out = decoder(pyramid, (float(CANVAS[0]), float(CANVAS[1])))
    (out.cls_logits.sum() + out.boxes.sum()).backward()
    torch.cuda.synchronize()
    counted = sample_cuda.launches - before[0], sample_cuda.backward_calls - before[1]
    if counted != (decoder.num_stages, decoder.num_stages) or not all(
            p.grad is not None and torch.isfinite(p.grad).all() for p in pyramid):
        raise AssertionError(f"adamixer_sample: a decoder step launched {counted} (forward, "
                             f"adjoint), expected one each a stage, or its pyramid gradients "
                             f"are missing or not finite")
    result["decoder_launches"] = list(counted)
    del decoder, pyramid, out
    torch.cuda.empty_cache()
    for key, res in result["canvases"].items():
        log(f"[adamixer_sample] {key}, batch {S1_BATCH}, {res['points']} points: forward "
            f"torch.equal to the eager route in float32 and float64; adjoint against "
            f"autograd float32 {max(res['float32']['adjoint_rel'].values()):.2e} "
            f"(tol {SAMPLE_ADJOINT_TOL[torch.float32]:g}), float64 "
            f"{max(res['float64']['adjoint_rel'].values()):.2e} "
            f"(tol {SAMPLE_ADJOINT_TOL[torch.float64]:g}); points with a clamped tap "
            f"{res['float32']['clamped_share']:.1%}")
        log(f"[adamixer_sample] {key} float32, each alone after an L2 flush: forward "
            f"{res['fwd_ms']:.4f} ms (bound {res['fwd_bound_ms']:.4f} ms, "
            f"{res['fwd_bytes'] / 1e6:.2f} MB, {res['cells']} tap cells: {res['fwd_share']:.1%}), "
            f"plain {res['plain_fwd_ms']:.4f} ms; adjoint {res['bwd_ms']:.4f} ms (bound "
            f"{res['bwd_bound_ms']:.4f} ms, {res['bwd_bytes'] / 1e6:.2f} MB: "
            f"{res['bwd_share']:.1%}), plain {res['plain_bwd_ms']:.4f} ms; card {card_line()}")
    log(f"[adamixer_sample] decoder forward and backward, batch {S1_BATCH}: "
        f"{counted[0]} forward and {counted[1]} adjoint launches")
    print(json.dumps({"adamixer_sample": result}), flush=True)
    return result


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


def phase_train():
    """The training main path through ``entry.train_entry``."""
    from skghoi_torch.entry import train_entry
    from skghoi_torch.ops.frozen_bn_cuda import frozen_bn_cuda
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
    roi_align_cuda.launches = roi_align_cuda.adjoint_launches = 0
    RoIAlignFunction.backward_calls = 0
    frozen_bn_cuda.launches = frozen_bn_cuda.backward_launches = 0
    rows = []
    for _ in range(TRAIN_STEPS):
        total, losses, out, applied = step(batch, generator)
        rows.append((applied, {k: float(v) for k, v in losses.items()}))
    launches, adjoints = roi_align_cuda.launches, RoIAlignFunction.backward_calls
    adjoint_launches = roi_align_cuda.adjoint_launches
    bn_launches = frozen_bn_cuda.launches, frozen_bn_cuda.backward_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    if not all(a for a, _ in rows) or not all(math.isfinite(v) for _, l in rows for v in l.values()):
        raise AssertionError(f"train: a step was skipped or a loss is not finite: {rows}")
    if launches != TRAIN_STEPS or adjoints != TRAIN_STEPS or adjoint_launches != TRAIN_STEPS:
        raise AssertionError(f"train: {launches} kernel launches, {adjoints} adjoints and "
                             f"{adjoint_launches} adjoint kernel launches in {TRAIN_STEPS} steps")
    want_bn = tuple(n * TRAIN_STEPS for n in frozen_bn_launches_per_step())
    if bn_launches != want_bn:
        raise AssertionError(f"train: {bn_launches} frozen_bn forward and backward launches in "
                             f"{TRAIN_STEPS} steps, expected {want_bn}")
    for n, p in model.named_parameters():
        if n in frozen and not torch.equal(p, frozen[n]):
            raise AssertionError(f"train: frozen parameter {n} changed")
    moved = [any(not torch.equal(p, q) for p, q in zip(g["params"], b))
             for g, b in zip(opt.param_groups, before)]
    if [g["name"] for g in opt.param_groups] != ["detector", "head"] or not all(moved):
        raise AssertionError(f"train: groups {[g['name'] for g in opt.param_groups]} moved {moved}")
    log(f"[train] bf16 SCG {CANVAS[0]}x{CANVAS[1]} batch {BATCH}, frozen_stages=1, AdamW lr "
        f"{[g['lr'] for g in opt.param_groups]}: {TRAIN_STEPS} steps, peak memory "
        f"{peak_gib:.2f} GiB, roi_align launches {launches}, adjoints {adjoints} (adjoint kernel "
        f"launches {adjoint_launches}), frozen_bn launches {bn_launches[0]} forward + "
        f"{bn_launches[1]} backward, n_h {out.n_h.tolist()} n {out.n.tolist()}")
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
    return dict(peak_gib=peak_gib, launches=launches, adjoints=adjoints,
                adjoint_launches=adjoint_launches, frozen_bn_launches=bn_launches[0] / TRAIN_STEPS,
                frozen_bn_backward_launches=bn_launches[1] / TRAIN_STEPS, guard_issue_ms=issue_ms,
                update_ms=update_ms)


def device_events(events):
    """The device rows of a profile's ``key_averages()``: kernels, copies and
    memsets.  A ``record_function`` range (``Optimizer.step#Adam.step``) also
    gets a device row spanning the kernels it wraps; counting it would count
    those kernels twice."""
    from torch.autograd import DeviceType

    return [e for e in events
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


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


# What phases 8, 9 and 12 leave for phase 14 (name -> path), kept in
# KEEP_DIR, which ``main`` makes and removes; with no KEEP_DIR (a phase run
# alone) nothing is kept and phase 14 makes its own inputs.
KEEP_DIR = None
ARTEFACTS: dict = {}


def keep(name: str, *sources, move: bool = False) -> None:
    """Copy (or move) files and directories into ``KEEP_DIR/name`` (one
    source: its copy is ``name`` itself) and record the path."""
    import shutil

    if KEEP_DIR is None:
        return
    dst = os.path.join(KEEP_DIR, name)
    for src in sources:
        target = dst if len(sources) == 1 else os.path.join(dst, os.path.basename(src))
        os.makedirs(os.path.dirname(target), exist_ok=True)
        if move:
            shutil.move(src, target)
        elif os.path.isdir(src):
            shutil.copytree(src, target)
        else:
            shutil.copy(src, target)
    ARTEFACTS[name] = dst


def keep_text(name: str, text: str) -> None:
    """Append ``text`` to ``KEEP_DIR/name``."""
    if KEEP_DIR is None:
        return
    ARTEFACTS[name] = os.path.join(KEEP_DIR, name)
    with open(ARTEFACTS[name], "a") as f:
        f.write(text)


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
        roi_align_cuda.launches = roi_align_cuda.adjoint_launches = 0
        RoIAlignFunction.backward_calls = 0
        t0 = time.perf_counter()
        engine, text = run_cli(train_hicodet.main, train_argv)
        train_s = time.perf_counter() - t0
        keep_text("train_hicodet.log", text)
        launches, adjoints = roi_align_cuda.launches, RoIAlignFunction.backward_calls
        adjoint_launches = roi_align_cuda.adjoint_launches
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
        if launches != steps + val_batches or adjoints != steps or adjoint_launches != steps:
            raise AssertionError(f"cli: {launches} kernel launches, {adjoints} adjoints and "
                                 f"{adjoint_launches} adjoint kernel launches for {steps} train "
                                 f"steps and {val_batches} validation batches")
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
            f"adjoints {adjoints} (adjoint kernel launches {adjoint_launches})")
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

        roi_align_cuda.launches = roi_align_cuda.adjoint_launches = 0
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
                or RoIAlignFunction.backward_calls != steps_per_epoch
                or roi_align_cuda.adjoint_launches != steps_per_epoch):
            raise AssertionError(f"cli --device-resize: losses {dr_losses}, launches "
                                 f"{roi_align_cuda.launches}, adjoint kernel launches "
                                 f"{roi_align_cuda.adjoint_launches}")
        log(f"[cli] --device-resize epoch: {steps_per_epoch} steps, losses finite, roi_align "
            f"launches {roi_align_cuda.launches}, adjoints {RoIAlignFunction.backward_calls} "
            f"(adjoint kernel launches {roi_align_cuda.adjoint_launches}); "
            f"steps after the first {[round(g * 1e3, 3) for g in dr_gaps]} ms with the loader")
        keep("hico", *[os.path.join(root, n) for n in (
            "hico_20160224_det", "instances_train2015.json", "instances_test2015.json",
            "detections_train2015", "detections_test2015")])
        keep("ckpt_02.pt", os.path.join(ckpts, "ckpt_02.pt"), move=True)

    return dict(dtype="float32", tf32=False, canvas=list(CANVAS), batch=BATCH,
                train_img_per_s=train_img_s, train_step_ms=[g * 1e3 for g in gaps],
                eval_img_per_s=eval_img_s, idle_share_traced_epoch=idle,
                traced_epoch_ms=epoch_s * 1e3, device_busy_ms=busy_ms, peak_gib=peak_gib,
                step_alone_ms=step_ms, checkpoint_ms=save_ms,
                train_steps=steps, val_batches=val_batches, launches=launches,
                adjoints=adjoints, adjoint_launches=adjoint_launches, test_launches=test_launches,
                map=dict(zip(("full", "rare", "non_rare"), maps)),
                device_preprocess_max_err=preprocess_err, host_pipeline=host,
                device_resize_step_ms=[g * 1e3 for g in dr_gaps])


# Published sizes of the KGE benchmarks (OpenKE benchmarks/*/{entity,relation,train,valid,test}2id.txt).
FB15K237 = dict(name="FB15K237", ent=14541, rel=237, train=272115, valid=17535, test=20466)
WN18RR = dict(name="WN18RR", ent=40943, rel=11, train=86835, valid=3034, test=3134)
KGE_EPOCHS = 5        # phase 9b: train_kge epochs, enough to show the loss falling
KGE_WN_EPOCHS = 2     # phase 9c
KGE_PARITY_STEPS = 3  # phase 9a: trainer steps held card vs CPU
KGE_PARITY_TEST = 128  # phase 9a: test triples ranked card vs CPU (the CPU ranking dominates)
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
    keep_text("kge_rows.jsonl", json.dumps(row) + "\n")
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
        keep("wn18rr", wn)
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


DDP_TOL = 1e-6  # phase 11: the NCCL run of one rank against the plain run, rtol
DET_TRAIN_IMAGES = 8  # phase 12: the landscape images train_hicodet --synthetic trains on
DET_PORTRAIT_IMAGES = 4  # phase 12: portrait images, so that both canvases reach the kernel
DET_SCORE_THRESH = "0.001"  # random weights give class probabilities near 1/91, under 0.05
DET_CPU_IMAGES = 2  # phase 12: images whose detections are held card against CPU
TIE_REL = 1e-4  # a flip is a tie when the scores involved agree to this share
IOU_TIE = 1e-3  # ... or the IoU that decided it is this close to the NMS threshold


def ddp_worker(kind: str, out_path: str, argv) -> int:
    """``--ddp-worker KIND OUT -- ARGS``: run ``train_hicodet.main(ARGS)``
    (``hoi``) or ``train_kge.main(ARGS)`` (``kge``) in this process, started
    plainly or by torchrun, and write what phase 11 compares to ``OUT``."""
    import warnings

    import torch.distributed as dist

    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda
    from skghoi_torch.parallel import distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # Both processes pick the same deterministic kernels, so that the one
    # difference between them is the process group.
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    device = distributed.device_for(cpu=False)
    grouped = distributed.initialize(device)  # a group of one under torchrun, none plainly
    backend = dist.get_backend() if grouped else None
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = _ddp_run(kind, argv)
    out.update(backend=backend, world=distributed.world_size(), launches=roi_align_cuda.launches,
               adjoint_launches=roi_align_cuda.adjoint_launches, device=str(device),
               nondeterministic=sorted({str(w.message)[:120] for w in seen
                                        if "deterministic" in str(w.message)}))
    distributed.shutdown()
    torch.save(out, out_path)
    return 0


def _ddp_run(kind: str, argv) -> dict:
    """The tool's losses, step ms and parameters after its run."""
    import re

    if kind == "hoi":
        from skghoi_torch.tools import train_hicodet

        engine, _ = run_cli(train_hicodet.main, argv)
        ends = engine.iteration_ends
        out = dict(losses=engine.step_losses,
                   step_ms=[(b - a) * 1e3 for a, b in zip(ends, ends[1:])],
                   params={k: v.detach().cpu() for k, v in engine.model.state_dict().items()})
        if torch.distributed.is_initialized():
            # The train step's one all-reduce alone: the gradients, the total
            # and the three losses, as build_train_step passes them.
            from skghoi_torch.parallel.mesh import all_reduce_mean_

            grads = [torch.zeros_like(p) for p in engine.model.parameters() if p.requires_grad]
            grads += [torch.zeros((), device=grads[0].device) for _ in range(4)]
            out.update(all_reduce_ms=cuda_ms(lambda: all_reduce_mean_(grads), iters=20),
                       all_reduce_values=sum(g.numel() for g in grads))
        return out
    from skghoi_torch.tools import train_kge

    _, text = run_cli(train_kge.main, argv)
    with open(argv[argv.index("--json-out") + 1]) as f:
        row = json.loads(f.read().strip().splitlines()[-1])
    return dict(losses=[float(x) for x in re.findall(r"^Epoch \d+ \| loss: (\S+) \|", text, re.M)],
                step_ms=[1e3 / row["steps_per_second"]],
                params=torch.load(argv[argv.index("--checkpoint") + 1], map_location="cpu",
                                  weights_only=True))


def run_ddp_worker(kind: str, argv, torchrun: bool, out_path: str):
    """``ddp_worker`` in a new process (under ``torch.distributed.run
    --standalone --nproc-per-node 1`` when ``torchrun``); its results."""
    script = os.path.abspath(__file__)
    cmd = [sys.executable, script, "--ddp-worker", kind, out_path, "--", *argv]
    if torchrun:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
               "1", *cmd[1:]]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(script),
                          env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[:8])} ... exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return torch.load(out_path, weights_only=False)


def phase_ddp():
    """Phase 11: data-parallel training on the one card: ``train_hicodet
    --synthetic`` and ``train_kge --example transe_fb15k237 --data-parallel``
    under torchrun with one rank (NCCL), each against the same run started
    plainly, losses and parameters at rtol ``DDP_TOL``."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory(prefix="skghoi_ddp_") as tmp:
        fb = write_synthetic_kg(os.path.join(tmp, "fb15k237"), FB15K237, seed=0)
        for kind in ("hoi", "kge"):
            runs = {}
            for torchrun in (False, True):
                tag = "torchrun" if torchrun else "plain"
                if kind == "hoi":
                    argv = ["--synthetic", "--synthetic-root", os.path.join(tmp, "synth"),
                            "--cache-dir", os.path.join(tmp, f"ck_{tag}"), "--batch-size", "2",
                            "--num-workers", "0"]
                else:
                    argv = ["--data", fb, "--example", "transe_fb15k237", "--epochs", "1",
                            "--data-parallel", "--checkpoint", os.path.join(tmp, f"kge_{tag}.pt"),
                            "--json-out", os.path.join(tmp, f"kge_{tag}.jsonl")]
                t0 = time.perf_counter()
                runs[tag] = run_ddp_worker(kind, argv, torchrun, os.path.join(tmp, f"{kind}_{tag}.pt"))
                runs[tag]["process_s"] = time.perf_counter() - t0
            plain, dp = runs["plain"], runs["torchrun"]
            if dp["backend"] != "nccl" or dp["world"] != 1 or plain["backend"] is not None:
                raise AssertionError(f"ddp {kind}: backend {dp['backend']} world {dp['world']}; "
                                     f"plain run backend {plain['backend']}")
            want = [v for step in plain["losses"] for v in (step.values() if kind == "hoi" else [step])]
            got = [v for step in dp["losses"] for v in (step.values() if kind == "hoi" else [step])]
            loss_rel = max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))
            param_rel, worst = max((((dp["params"][k].float() - v.float()).abs().max()
                                     / v.float().abs().max().clamp_min(1e-30)).item(), k)
                                   for k, v in plain["params"].items() if v.is_floating_point())
            ok = (len(got) == len(want) > 0 and loss_rel <= DDP_TOL and param_rel <= DDP_TOL
                  and all(map(math.isfinite, got)))
            entry = dict(losses_plain=plain["losses"], losses_nccl=dp["losses"], loss_rel=loss_rel,
                         param_rel=param_rel, step_ms_plain=plain["step_ms"],
                         step_ms_nccl=dp["step_ms"], launches_plain=plain["launches"],
                         launches_nccl=dp["launches"],
                         adjoint_launches_plain=plain["adjoint_launches"],
                         adjoint_launches_nccl=dp["adjoint_launches"],
                         process_s_plain=plain["process_s"],
                         process_s_nccl=dp["process_s"])
            if kind == "hoi":
                entry.update(all_reduce_ms=dp["all_reduce_ms"],
                             all_reduce_values=dp["all_reduce_values"])
                log(f"[ddp] hoi: the step's all_reduce_mean_ alone over {dp['all_reduce_values']} "
                    f"float32 values (flat cat, NCCL all-reduce at world 1, divide, copy back): "
                    f"{dp['all_reduce_ms']:.3f} ms a call (CUDA events, mean of 20)")
            log(f"[ddp] {kind}: torchrun --nproc-per-node 1 (NCCL, world 1) against the plain "
                f"process: {len(got)} losses, max rel diff {loss_rel:.3e}, parameters max rel diff "
                f"{param_rel:.3e} ({worst}) (rtol {DDP_TOL:g}) {'ok' if ok else 'FAIL'}; step ms plain "
                f"{[round(x, 3) for x in plain['step_ms']]} NCCL {[round(x, 3) for x in dp['step_ms']]}; "
                f"roi_align launches plain {plain['launches']} NCCL {dp['launches']}, adjoint "
                f"kernel launches plain {plain['adjoint_launches']} NCCL {dp['adjoint_launches']}; "
                f"ops without a "
                f"deterministic kernel {plain['nondeterministic']}; two-rank "
                f"parity is the CPU test's (tests/test_torch_port_ddp.py): this smoke has one card")
            if not ok:
                raise AssertionError(f"ddp {kind}: the NCCL run differs from the plain run")
            steps = len(got) // 3
            if kind == "hoi" and not (dp["launches"] == plain["launches"] == steps
                                      == dp["adjoint_launches"] == plain["adjoint_launches"]):
                raise AssertionError(f"ddp hoi: roi_align launches {plain['launches']}/{dp['launches']}, "
                                     f"adjoint kernel launches {plain['adjoint_launches']}/"
                                     f"{dp['adjoint_launches']} for {steps} steps")
            out[kind] = entry
    return out


def _np_iou(a, b):
    from skghoi_torch.ops.ap import _np_box_iou

    return _np_box_iou(np.asarray(a, np.float64), np.asarray(b, np.float64))


def _held(a, b, box_tol, score_rel=None, chunk=512):
    """Whether ``b`` holds each entry of ``a`` (both ``(boxes [N, 4],
    scores [N], labels [N])``, numpy): an entry of the same label with its
    box within ``box_tol`` pixels and, unless ``score_rel`` is None, its
    score within ``score_rel`` of ``a``'s."""
    out = np.zeros(len(a[1]), bool)
    for i in range(0, len(out) if len(b[1]) else 0, chunk):
        sl = slice(i, i + chunk)
        same = (a[2][sl, None] == b[2][None]) & (
            np.abs(a[0][sl, None, :] - b[0][None]).max(-1) <= box_tol)
        if score_rel is not None:
            same &= np.abs(a[1][sl, None] - b[1][None]) <= score_rel * np.abs(a[1][sl, None])
        out[sl] = same.any(1)
    return out


def _at_cut(score, label, mine, other, by_label):
    """Whether an entry of pool ``mine`` that pool ``other`` lacks fell at
    ``other``'s top-k cut: both pools keep the same number of entries (of
    its label, with ``by_label``) and its score is at or below ``other``'s
    lowest (of its label)."""
    in_mine = mine[2] == label if by_label else np.ones(len(mine[2]), bool)
    in_other = other[2] == label if by_label else np.ones(len(other[2]), bool)
    return bool(in_other.any() and in_mine.sum() == in_other.sum()
                and score <= other[1][in_other].min() * (1 + TIE_REL))


def selection_flips(got, want, iou_thresh, pools, by_label, box_tol=1e-2):
    """Two runs of one selection: the card's (``got``) and the CPU's
    (``want``) entries kept by NMS and a top-k, each selected from its own
    candidate pool (``pools``, the card's and the CPU's); all of them
    ``(boxes [N, 4], scores [N], labels [N])`` of valid entries, numpy.
    A pool is a top-k, of each label with ``by_label`` (the RPN's per-level
    top-k).  Returns the entries of each selection with no entry of the same
    label and box (within ``box_tol`` pixels) in the other, the entries of
    each pool that the other pool lacks, and those of both that no tie
    explains.

    The pools must agree: an entry of one is held by the other (same label,
    box within ``box_tol``, score within ``TIE_REL``) unless it fell at the
    other's cut (:func:`_at_cut`).  A selected entry must be one of its own
    pool's, exactly.  An entry ``x`` that one selection keeps and the other
    does not is a tie when
    - the other pool lacks it at its cut; or
    - the other pool holds it and the other selection keeps, in its place, an
      entry of the same label that this one does not keep, overlapping ``x``
      at an IoU of at least ``iou_thresh - IOU_TIE`` and scoring at least
      ``x``'s less ``TIE_REL`` (``x`` was suppressed by a flipped entry: two
      near-equal scores in other order, or the consequence of such a swap);
      or
    - it overlaps a same-label entry of either selection at an IoU within
      ``IOU_TIE`` of ``iou_thresh`` (a suppression decided at the threshold);
      or
    - both selections keep the same number of entries and its score is at or
      below the other's lowest (displaced at the final cut by another flip).
    A box moved on one side (decode, clip, gather) breaks the pools'
    agreement or the selection's membership, and no rule excuses it."""
    unexplained = []
    pool_misses = 0
    for (pa, pb) in (pools, pools[::-1]):
        for i in np.nonzero(~_held(pa, pb, box_tol, TIE_REL))[0]:
            pool_misses += 1
            if not _at_cut(pa[1][i], pa[2][i], pa, pb, by_label):
                unexplained.append(("pool", float(pa[1][i]), int(pa[2][i])))
    sides = [np.nonzero(~_held(a, b, box_tol))[0] for a, b in ((got, want), (want, got))]
    runs = (((got, want), pools, sides[0], sides[1]), ((want, got), pools[::-1], sides[1], sides[0]))
    for (a, b), (pa, pb), mine, theirs in runs:
        own = _held(a, pa, 0.0, 0.0)
        held = _held(a, pb, box_tol, TIE_REL)
        for i in np.nonzero(~own)[0]:
            unexplained.append(("not from its pool", float(a[1][i]), int(a[2][i])))
        for i in mine:
            s, label = a[1][i], a[2][i]
            if not own[i]:
                continue
            if not held[i]:
                if not _at_cut(s, label, pa, pb, by_label):
                    unexplained.append(("other pool", float(s), int(label)))
                continue
            rivals = [j for j in theirs if b[2][j] == label and b[1][j] >= s * (1 - TIE_REL)]
            if rivals and (_np_iou(a[0][i:i + 1], b[0][rivals])[0] >= iou_thresh - IOU_TIE).any():
                continue
            near = False
            for boxes, labels in ((a[0], a[2]), (b[0], b[2])):
                sel = labels == label
                if sel.any():
                    iou = _np_iou(a[0][i:i + 1], boxes[sel])[0]
                    near |= bool((np.abs(iou - iou_thresh) <= IOU_TIE).any())
            if near:
                continue
            if len(a[1]) == len(b[1]) and s <= b[1].min() * (1 + TIE_REL):
                continue
            unexplained.append(("selection", float(s), int(label)))
    return len(sides[0]) + len(sides[1]), pool_misses, unexplained


def _valid(boxes, scores, labels, valid):
    v = valid.cpu().numpy().astype(bool)
    return (boxes.cpu().numpy()[v].astype(np.float64), scores.cpu().numpy()[v].astype(np.float64),
            labels.cpu().numpy()[v])


def _all(boxes, scores, labels):
    return _valid(boxes, scores, labels, torch.ones_like(scores, dtype=torch.bool))


def _moved(entries, dx=0.5):
    """``entries`` with every box shifted ``dx`` pixels right: a planted
    device error that leaves the scores alone."""
    return entries[0] + np.array([dx, 0.0, dx, 0.0]), entries[1], entries[2]


def write_coco_to_hico(root):
    """COCO's 80 category ids in order onto 0..79: a stand-in for the
    dataset's coco80tohico80.json, so labels land in HICO's range."""
    coco = [i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
    with open(os.path.join(root, "coco80tohico80.json"), "w") as f:
        json.dump({str(c): h for h, c in enumerate(coco)}, f)


def hold_detector_on_cpu(card, cpu, image, size):
    """The detector on the card against the same detector on the CPU, stage
    by stage: the RPN's pool and proposals (NMS at 0.7 with levels as
    labels), then the RoI heads' pool and detections on the card's proposals
    (class NMS at 0.5).  Returns the flips of each, all ties; then plants a
    box offset on the card's side, which the check must refuse."""
    out = {}
    canvas = tuple(image.shape[1:3])
    with torch.no_grad():
        feats = card.features(image.cuda())
        pool = card.rpn_candidates(feats, canvas, size.cuda())
        props = card.propose(feats, canvas, size.cuda())
        cand = card.classify(feats, props, size.cuda())
        det = card.select(cand)
        cfeats = cpu.features(image)
        cpool = cpu.rpn_candidates(cfeats, canvas, size)
        cprops = cpu.propose(cfeats, canvas, size)
        cprops_from_card = props._replace(boxes=props.boxes.cpu(), scores=props.scores.cpu(),
                                          valid=props.valid.cpu(), levels=props.levels.cpu())
        ccand = cpu.classify(cfeats, cprops_from_card, size)
        cdet = cpu.select(ccand)
    out["feature_rel"] = max(((f.cpu() - c).abs().max() / c.abs().max()).item()
                             for f, c in zip(feats, cfeats))
    stages = {
        "proposal": (_valid(props.boxes, props.scores, props.levels, props.valid),
                     _valid(cprops.boxes, cprops.scores, cprops.levels, cprops.valid), 0.7,
                     (_all(pool.boxes, pool.scores, pool.labels),
                      _all(cpool.boxes, cpool.scores, cpool.labels)), True),
        "detection": (_valid(det.boxes, det.scores, det.labels, det.valid),
                      _valid(cdet.boxes, cdet.scores, cdet.labels, cdet.valid), 0.5,
                      (_valid(*cand), _valid(*ccand)), False),
    }
    bad = {}
    for name, (got, want, thresh, pools, by_label) in stages.items():
        out[f"{name}_flips"], out[f"{name}_pool_misses"], bad[name] = selection_flips(
            got, want, thresh, pools, by_label)
        planted = [selection_flips(_moved(got), want, thresh, (_moved(pools[0]), pools[1]),
                                   by_label)[2],
                   selection_flips(_moved(got), want, thresh, pools, by_label)[2]]
        if not all(planted):
            raise AssertionError(f"detector card vs CPU: the {name} check passes a box moved by "
                                 f"0.5 px on the card")
    out["detections"] = int(det.valid.sum())
    if any(bad.values()) or out["feature_rel"] > 1e-3:
        raise AssertionError(f"detector card vs CPU: unexplained flips {bad}, features rel "
                             f"{out['feature_rel']:.3e}")
    return out


# sqrt(area) of each quarter of the spread proposals: LevelMapper levels P2..P5
SPREAD_SIDES = (64.0, 160.0, 320.0, 560.0)


def spread_levels(boxes, size):
    """The detector's ``[1, N, 4]`` proposals with a quarter of them rescaled
    onto each of P2..P5: each box keeps its aspect ratio (clamped to [1/2,
    2]) and its centre (moved inward so that it stays in the ``size`` image)
    and takes its quarter's ``SPREAD_SIDES`` side.  Random weights send every
    real proposal to P2; a trained RPN spreads them over the levels."""
    b = boxes[0]
    n = b.shape[0]
    side = torch.tensor(SPREAD_SIDES, device=b.device).repeat_interleave(-(-n // 4))[:n]
    aspect = ((b[:, 2] - b[:, 0]).clamp_min(1.0) / (b[:, 3] - b[:, 1]).clamp_min(1.0)).clamp(0.5, 2.0)
    w, h = side * aspect.sqrt(), side / aspect.sqrt()
    hi = size.to(b.device).flatten()
    cx = ((b[:, 0] + b[:, 2]) / 2).clamp(min=w / 2, max=hi[1] - w / 2)
    cy = ((b[:, 1] + b[:, 3]) / 2).clamp(min=h / 2, max=hi[0] - h / 2)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)[None].contiguous()


def check_kernel_frcnn(feats, boxes):
    """The kernel against its plain version on the detector's inputs
    (float32 P2..P5, ``[1, 1000, 4]`` proposals), then timed: cold L2 (three
    copies of the pyramid in turns) and warm, both as CUDA graphs."""
    from skghoi_torch.ops.roi_align import fpn_level_assignment, multiscale_roi_align
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda

    maps = [f.contiguous() for f in feats]
    got = roi_align_cuda.launch(maps, boxes, fpn_level_assignment(boxes).contiguous(),
                                torch.empty((*boxes.shape[:2], 7, 7, maps[0].shape[-1]),
                                            device="cuda"))
    want = multiscale_roi_align(maps, boxes)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL):
        raise AssertionError(f"roi_align kernel disagrees with plain version on the detector's "
                             f"proposals: {err:.3e}")
    levels = fpn_level_assignment(boxes).contiguous()
    out = torch.empty_like(got)
    copies = [maps] + [[m.clone() for m in maps] for _ in range(2)]
    cold = graph_ms([(lambda m: lambda: roi_align_cuda.launch(m, boxes, levels, out))(copies[i % 3])
                     for i in range(30)], iters=20)
    warm = graph_ms([lambda: roi_align_cuda.launch(maps, boxes, levels, out)] * 20, iters=20)
    plain = cuda_ms(lambda: multiscale_roi_align(maps, boxes), iters=5)
    bound = roi_forward_bound_s([m.shape for m in maps], boxes, maps[0].element_size(),
                                HBM_BYTES_PER_S, FP32_FLOPS_PER_S) * 1e3
    return dict(err=err, cold_ms=cold, warm_ms=warm, plain_ms=plain, bound_ms=bound,
                level_counts=torch.bincount(levels.flatten(), minlength=4).tolist())


def time_detector_stages(model, image, size, reps=3):
    """Median host ms of each stage of one image (the stage's launches and
    its wait for the device), the NMS steps, and one traced image: device
    busy time, device ops and idle share.  Returns them with the last run's
    pyramid and proposals."""
    from torch.profiler import ProfilerActivity, profile

    from skghoi_torch.detect.frcnn import Candidates

    image, size = image.cuda(), size.cuda()
    canvas = tuple(image.shape[1:3])
    stages = dict(backbone_fpn=[], rpn=[], roi_heads=[], class_nms=[], total=[])
    with torch.no_grad():
        for _ in range(reps + 1):
            t = [time.perf_counter()]
            feats = model.features(image)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            props = model.propose(feats, canvas, size)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            cand = model.classify(feats, props, size)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            model.select(cand)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            for name, a, b in zip(("backbone_fpn", "rpn", "roi_heads", "class_nms"), t, t[1:]):
                stages[name].append((b - a) * 1e3)
            stages["total"].append((t[-1] - t[0]) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(image, size)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
    device = device_events(prof.key_averages())
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    if not busy_ms:
        raise AssertionError("detector: the profiler saw no device time")
    med = {k: sorted(v[1:])[len(v[1:]) // 2] for k, v in stages.items()}
    return dict(stage_ms=med, nms_steps=props.candidates + cand.scores.shape[1],
                rpn_nms_steps=props.candidates, class_nms_steps=cand.scores.shape[1],
                device_ops=sum(e.count for e in device), device_busy_ms=busy_ms,
                traced_ms=traced_ms, idle_share=max(0.0, 1 - busy_ms / traced_ms)), feats, props


def phase_detect():
    """Phase 12: stage-1 detection at full width: a seeded random
    torchvision-layout ``fasterrcnn_resnet50_fpn`` checkpoint through
    ``preprocess_detections.main`` on synthetic landscape and portrait
    images; the kernel on the real proposals; card against CPU; the cached
    JSON files read by one ``train_hicodet --synthetic`` epoch."""
    import tempfile

    from skghoi_torch.data.synthetic import make_synthetic_hicodet
    from skghoi_torch.detect.frcnn import FasterRCNN, load_torch_fasterrcnn, random_state_dict
    from skghoi_torch.ops.frozen_bn_cuda import frozen_bn_cuda
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda
    from skghoi_torch.tools import preprocess_detections, train_hicodet
    from skghoi_torch.tools.preprocess_detections import detector_input

    out = {}
    with tempfile.TemporaryDirectory(prefix="skghoi_det_") as root:
        t0 = time.perf_counter()
        sd = random_state_dict(0)
        ckpt = os.path.join(root, "fasterrcnn_resnet50_fpn.pt")
        torch.save(sd, ckpt)
        log(f"[detect] seeded torchvision-layout fasterrcnn_resnet50_fpn state_dict: "
            f"{sum(v.numel() for v in sd.values())} values, written in {time.perf_counter() - t0:.2f} s")
        make_synthetic_hicodet(root, "train2015", num_images=DET_TRAIN_IMAGES)  # train_hicodet's
        make_synthetic_hicodet(root, "test2015", num_images=DET_PORTRAIT_IMAGES,
                               image_size=(640, 480), seed=1)
        write_coco_to_hico(root)

        cache = os.path.join(root, "detections")
        n_images, wall, per_image = 0, 0.0, []
        roi_align_cuda.launches = 0
        frozen_bn_cuda.launches = frozen_bn_cuda.backward_launches = 0
        for part, n in (("train2015", DET_TRAIN_IMAGES), ("test2015", DET_PORTRAIT_IMAGES)):
            t0 = time.perf_counter()
            run_cli(preprocess_detections.main, [
                "--data-root", root, "--partition", part, "--ckpt-path", ckpt,
                "--cache-dir", cache, "--score-thresh", DET_SCORE_THRESH])
            wall += time.perf_counter() - t0
            n_images += n
            files = sorted(os.listdir(os.path.join(cache, part)))
            dets = []
            for name in files:
                with open(os.path.join(cache, part, name)) as f:
                    dets.append(json.load(f))
            if len(files) != n or not all(d["boxes"] and set(d) == {"boxes", "labels", "scores"}
                                          for d in dets):
                raise AssertionError(f"preprocess_detections {part}: {len(files)} files")
            if not all(0 <= l < 80 for d in dets for l in d["labels"]):
                raise AssertionError(f"preprocess_detections {part}: labels outside HICO's 80")
            per_image += [len(d["boxes"]) for d in dets]
        launches = roi_align_cuda.launches
        bn_launches = frozen_bn_cuda.launches, frozen_bn_cuda.backward_launches
        if launches != n_images:
            raise AssertionError(f"detector: {launches} roi_align launches for {n_images} images")
        if bn_launches != (frozen_bn_launches_per_step()[0] * n_images, 0):
            raise AssertionError(f"detector: {bn_launches} frozen_bn forward and backward launches "
                                 f"for {n_images} images")
        out.update(images=n_images, images_per_s=n_images / wall, cli_s=wall, launches=launches,
                   frozen_bn_launches=bn_launches[0] / n_images, detections_per_image=per_image)
        log(f"[detect] preprocess_detections --score-thresh {DET_SCORE_THRESH}, {n_images} images "
            f"({DET_TRAIN_IMAGES} 120x160 -> 832x1344 canvas, {DET_PORTRAIT_IMAGES} 640x480 -> "
            f"1344x832), float32: {wall:.3f} s, {out['images_per_s']:.3f} images/s with the "
            f"tool's host resize and JSON writes (one model load a partition); roi_align launches "
            f"{launches}, frozen_bn launches {bn_launches[0]}")

        card = FasterRCNN(box_score_thresh=float(DET_SCORE_THRESH))
        card.load_state_dict(load_torch_fasterrcnn(sd), strict=True)
        cpu = FasterRCNN(box_score_thresh=float(DET_SCORE_THRESH), device="cpu")
        cpu.load_state_dict(load_torch_fasterrcnn(sd), strict=True)
        from skghoi_torch.data.hicodet import HICODet

        out["canvases"] = {}
        for part, tag in (("train2015", "landscape"), ("test2015", "portrait")):
            ds = HICODet(os.path.join(root, f"hico_20160224_det/images/{part}"),
                         os.path.join(root, f"instances_{part}.json"))
            arr = np.asarray(ds[0][0], np.float32) / 255.0
            padded, hw, _ = detector_input(arr)
            image = torch.from_numpy(padded)[None]
            size = torch.tensor([[float(hw[0]), float(hw[1])]])
            entry, feats, props = time_detector_stages(card, image, size)
            roi = check_kernel_frcnn(feats, props.boxes)
            spread = check_kernel_frcnn(feats, spread_levels(props.boxes, size))
            if 0 in spread["level_counts"]:
                raise AssertionError(f"spread proposals leave a level empty: {spread['level_counts']}")
            entry["kernel"], entry["kernel_spread"] = roi, spread
            entry["cpu"] = hold_detector_on_cpu(card, cpu, image, size)
            out["canvases"][f"{tag} {padded.shape[0]}x{padded.shape[1]}"] = entry
            st = entry["stage_ms"]
            log(f"[detect] {tag} {padded.shape[0]}x{padded.shape[1]} ({hw[0]}x{hw[1]} image): ms an "
                f"image (median of 3, host clock to synchronize) backbone+FPN {st['backbone_fpn']:.3f}, "
                f"RPN with its NMS {st['rpn']:.3f}, RoI heads {st['roi_heads']:.3f}, class NMS "
                f"{st['class_nms']:.3f}, total {st['total']:.3f} ({1e3 / st['total']:.3f} images/s "
                f"for the model alone); NMS steps {entry['nms_steps']} ({entry['rpn_nms_steps']} RPN + "
                f"{entry['class_nms_steps']} class); traced image {entry['traced_ms']:.3f} ms, device "
                f"busy {entry['device_busy_ms']:.3f} ms in {entry['device_ops']} device ops: idle "
                f"{entry['idle_share']:.1%}")
            for what, r in (("the detector's proposals", roi),
                            ("the same proposals spread over the levels (sides "
                             f"{'/'.join(f'{v:g}' for v in SPREAD_SIDES)})", spread)):
                log(f"[detect] roi_align on {what} {tuple(props.boxes.shape)} (levels P2..P5 "
                    f"{r['level_counts']}), float32 C=256: max|kernel-plain| {r['err']:.3e} "
                    f"(rtol=atol={FP32_TOL:g}) ok; cold L2 {r['cold_ms'] * 1e3:.3f} us, warm "
                    f"{r['warm_ms'] * 1e3:.3f} us (CUDA graph), plain {r['plain_ms']:.4f} ms; bound "
                    f"{r['bound_ms'] * 1e3:.3f} us: cold at "
                    f"{r['bound_ms'] / r['cold_ms']:.1%} of it")
            c = entry["cpu"]
            log(f"[detect] card against CPU ({tag}): features max rel diff {c['feature_rel']:.3e}; "
                f"RPN pool entries the other run lacks {c['proposal_pool_misses']}, proposal flips "
                f"{c['proposal_flips']}; RoI-head pool misses {c['detection_pool_misses']}, detection "
                f"flips {c['detection_flips']} of {c['detections']} detections; each a tie (score "
                f"within {TIE_REL:g} or IoU within {IOU_TIE:g} of the NMS threshold, or at a cut); a "
                f"box moved 0.5 px on the card is refused at both stages")

        roi_align_cuda.launches = 0
        engine, text = run_cli(train_hicodet.main, [
            "--synthetic", "--synthetic-root", root, "--train-detection-dir",
            os.path.join(cache, "train2015"), "--box-score-thresh", "0", "--batch-size", "4",
            "--num-workers", "0", "--cache-dir", os.path.join(root, "ck")])
        losses = [v for step in engine.step_losses for v in step.values()]
        if ("Training complete." not in text or engine.iteration != 2
                or not all(map(math.isfinite, losses)) or roi_align_cuda.launches != 2):
            raise AssertionError(f"train_hicodet on the detector's JSON: {engine.iteration} steps, "
                                 f"losses {losses}, {roi_align_cuda.launches} launches")
        out["stage2"] = dict(steps=engine.iteration, losses=engine.step_losses,
                             launches=roi_align_cuda.launches)
        keep("detect", *[os.path.join(root, n) for n in (
            "hico_20160224_det", "instances_train2015.json", "instances_test2015.json",
            "detections")])
        log(f"[detect] train_hicodet --synthetic --train-detection-dir <the detector's JSON> "
            f"--box-score-thresh 0: {engine.iteration} steps, losses {engine.step_losses}")
    return out


S1_BATCH = 4  # phase 13: the detectors' train batch at 832x1344
S1_TIMED = 3  # phase 13a: timed train steps of the FPN detector, after one warm-up
# phase 13b: AdaMixer's train steps between its two card-vs-CPU checks; the
# float64 check after training holds the state these eight steps reach
S1_ADAMIXER_STEPS = 8
S1_LOGIT_TOL = 1e-5  # phase 13: FPN card vs CPU, relative to each output's largest
S1_LOSS_RTOL = 1e-4  # phase 13: first-step losses card vs CPU
S1_ADAMIXER_TOL = 1e-4  # phase 13: AdaMixer per-stage outputs card vs CPU, relative
S1_DETR_TOL = 1e-4  # phase 13: DETR logits and boxes card vs CPU, relative
S1_GRAD_TOL = 1e-3  # phase 13: card vs CPU gradients, relative to each tensor's largest
# phase 13: an FPN gradient past S1_GRAD_TOL, card vs a float64 CPU run
# (float32 holds one of them only to 4.7e-3 on the CPU)
S1_GRAD_FLOAT64_TOL = 2e-2
# phase 13: AdaMixer's gradients card vs CPU, both models in float64,
# relative to each tensor's largest: its backbone's at init, from the CPU's
# pyramid gradients on both sides, its pyramid's and decoder's after
# training.  In float32 its trained weights make many gradients
# ill-conditioned (card and CPU up to 2.3e-2 and 1.1e-2 from float64, the
# worse side changing tensor by tensor and run to run); at init its
# sampling points sit where bilinear sampling's derivative jumps (the
# card's offset generator gradients 5-90% from float64).  The trained
# six-stage decoder turns a difference in its input pyramid into decoder
# gradient differences up to some 2 000 times larger, run by run (on an
# H100, with FrozenBatchNorm's constants in float32: pyramids 5e-7-1e-6
# apart, decoder gradients 1.8e-6-1.6e-3), so these hold only while both
# pyramids are float64 throughout (S1_PYR64_TOL).
S1_GRAD64_TOL = 1e-4
# phase 13: AdaMixer's float64 pyramid card vs CPU at the same weights, each
# level relative to its largest, held before any gradient: float64 rounding
# through the ~60 layers of ResNet-50 + FPN is ~1e-13, one layer computed in
# float32 ~1e-7, so a miss says that a float64 copy is not float64.
S1_PYR64_TOL = 1e-10
# phase 13e: bfloat16 on the card against bfloat16 on the CPU, each output
# of each image within S1_BF16_FACTOR x the card's own bfloat16-against-
# float32 gap on it, and that gap under S1_BF16_GAP_MAX of the output's
# largest, so that a broken bfloat16 path cannot pass by a large gap.  On an
# H100 over 6 seeds x 8 images x 2 outputs (scripts/detr_bf16_readings.py)
# the ratio was at most 0.86 (boxes, where the gap is smallest), median 0.35.
S1_BF16_FACTOR = 2.0
S1_BF16_GAP_MAX = 0.1
DETR_BENCH_BATCH = 8  # phase 13e: bench.py --stage1's shape, 832x1344 at batch 8


def _rel(a, b):
    """Largest |a - b| over the largest |b|, computed in float64."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _grads(model, loss):
    """The gradients of ``loss`` by parameter name, on the host."""
    model.zero_grad(set_to_none=True)
    loss.backward()
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}


def _float64_copy(model):
    """A float64 copy of a model: every parameter and buffer float64, and
    every layer with a ``compute_dtype`` set to float64, so that every
    floating op computes in float64 (``tests/test_torch_port_float64.py``
    logs the ops of the detectors' copies; phase 13b holds the card's
    pyramid to the CPU's at ``S1_PYR64_TOL``)."""
    import copy

    model = copy.deepcopy(model).double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return model


def _grad_rel(got, want):
    """{name: largest |got - want| over the largest |want|}; the attention's
    key bias, whose exact gradient is 0, at the key weight's scale."""
    if got.keys() != want.keys():
        raise AssertionError(f"gradients of {sorted(got.keys() ^ want.keys())} on one side only")
    return {name: (got[name].double() - w.double()).abs().max().item() / max(
        want[name.replace("key.bias", "key.weight")].abs().max().item(), 1e-30)
        for name, w in want.items()}


def grad_check(got, want, exact):
    """The card's gradients ``got`` against the CPU's ``want`` (one step from
    the same weights and batch): each within ``S1_GRAD_TOL`` of the CPU
    tensor's largest, or else within ``S1_GRAD_FLOAT64_TOL`` of a float64
    CPU run (``exact()``, called only then).  Returns (the largest relative
    difference within ``S1_GRAD_TOL``, {name: [card, CPU] distances from
    float64}, the failures)."""
    rel = _grad_rel(got, want)
    far = [name for name, r in rel.items() if r > S1_GRAD_TOL]
    ref = exact() if far else {}
    held = {name: [_rel(g[name], ref[name]) for g in (got, want)] for name in far}
    bad = [name for name in far if held[name][0] > S1_GRAD_FLOAT64_TOL]
    return max([r for r in rel.values() if r <= S1_GRAD_TOL], default=0.0), held, bad


def _detector_batch(root, batch):
    """The first ``batch`` images of synthetic HICO-DET at 832x1344 (the
    loader's resize into the landscape canvas) with their detector GT, on
    the card."""
    from skghoi_torch.data.factory import DataFactory, HOILoader, to_device
    from skghoi_torch.tools.train_detector import ground_truth

    factory = DataFactory("hicodet", "train2015", root, os.path.join(root, "detections_train2015"))
    hoi = to_device(next(iter(HOILoader(factory, batch, with_targets=True)))[0], "cuda")
    if tuple(hoi.images.shape[1:3]) != CANVAS:
        raise AssertionError(f"detector batch canvas {tuple(hoi.images.shape[1:3])}")
    return hoi.images, ground_truth(hoi.targets)


def _timed_steps(run, n):
    """``run()`` once to warm up, then ``n`` times: host ms of each (to a
    ``synchronize``), and one traced call's device busy ms and idle share."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    device = device_events(prof.key_averages())
    busy = sum(e.self_device_time_total for e in device) / 1e3
    if not busy:
        raise AssertionError("stage 1: the profiler saw no device time")
    return dict(step_ms=ms, median_ms=sorted(ms)[n // 2], traced_ms=traced, device_busy_ms=busy,
                device_ops=sum(e.count for e in device), idle_share=max(0.0, 1 - busy / traced))


def stage1_fpn(images, gt):
    """Phase 13a: FPNDetector card against CPU on one image (same seed): the
    outputs, the losses and every gradient (``grad_check``),
    ``decode_detections`` held by ``selection_flips``; then the train step at
    batch ``S1_BATCH`` and the decode timed."""
    from skghoi_torch.detect.detector import (FPNDetector, decode_candidates, decode_detections,
                                              detector_loss, generate_anchors)
    from skghoi_torch.tools.train_detector import adamw, build_fpn_step

    out = {}
    anchors = torch.from_numpy(generate_anchors(CANVAS))
    card, cpu = FPNDetector(device="cuda"), FPNDetector(device="cpu")
    one = [t[:1] for t in gt]
    cpu_one = [t.cpu() for t in one]
    got, want = card(images[:1]), cpu(images[:1].cpu())
    out["logits_rel"], out["deltas_rel"] = _rel(got[0], want[0]), _rel(got[1], want[1])
    lg = detector_loss(*got, anchors.cuda(), *one)
    lw = detector_loss(*want, anchors, *cpu_one)
    out["loss_rel"] = max(abs(lg[k].item() - lw[k].item()) / abs(lw[k].item()) for k in lw)

    def exact():
        f64 = _float64_copy(cpu)
        return _grads(f64, sum(detector_loss(*f64(images[:1].cpu().double()), anchors,
                                             *cpu_one).values()))

    out["grad_rel"], out["grads_held_to_float64"], bad_grads = grad_check(
        _grads(card, sum(lg.values())), _grads(cpu, sum(lw.values())), exact)
    out["gradients"] = sum(1 for p in cpu.parameters() if p.grad is not None)
    if bad_grads:
        raise AssertionError(f"FPN card vs CPU gradients: {bad_grads}, {out}")
    got, want = tuple(t.detach() for t in got), tuple(t.detach() for t in want)
    with torch.no_grad():
        thresh = float(DET_SCORE_THRESH)
        dets = [decode_detections(*o, a, CANVAS, score_thresh=thresh)
                for o, a in ((got, anchors.cuda()), (want, anchors))]
        pools = [decode_candidates(*o, a, CANVAS) for o, a in ((got, anchors.cuda()), (want, anchors))]
    sel = [_valid(d.boxes[0], d.scores[0], d.labels[0], d.valid[0]) for d in dets]
    pool = [_all(p[0][0], p[1][0], p[2][0]) for p in pools]
    out["flips"], out["pool_misses"], bad = selection_flips(sel[0], sel[1], 0.5, pool, False)
    planted = [selection_flips(_moved(sel[0]), sel[1], 0.5, (_moved(pool[0]), pool[1]), False)[2],
               selection_flips(_moved(sel[0]), sel[1], 0.5, pool, False)[2]]
    out["detections"] = len(sel[0][1])
    if not all(planted):
        raise AssertionError("FPN card vs CPU: the check passes a box moved by 0.5 px on the card")
    if (bad or out["logits_rel"] > S1_LOGIT_TOL or out["deltas_rel"] > S1_LOGIT_TOL
            or out["loss_rel"] > S1_LOSS_RTOL or not out["detections"]):
        raise AssertionError(f"FPN card vs CPU: {out}, unexplained flips {bad}")
    del cpu

    step = build_fpn_step(card, adamw(card, 1e-4, 1e-4))
    losses = []
    out.update(_timed_steps(lambda: losses.append(step(images, *gt)), S1_TIMED))
    losses = [v.item() for step_losses in losses for v in step_losses.values()]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"FPN train step losses {losses}")
    out["img_per_s"] = S1_BATCH * 1e3 / out["median_ms"]
    out["losses_first_last"] = [losses[:2], losses[-2:]]
    with torch.no_grad():
        logits, deltas = card(images[:1])
        a = anchors.cuda()
        decode = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode_detections(logits, deltas, a, CANVAS, score_thresh=float(DET_SCORE_THRESH))
            torch.cuda.synchronize()
            decode.append((time.perf_counter() - t0) * 1e3)
    out.update(decode_ms=sorted(decode[1:])[1], decode_nms_steps=1000, anchors=len(anchors))
    return out


def _adamixer_grads(model, images, assign, gt, hw, upstream=None):
    """One set-loss backward split at the pyramid -> (the loss, the
    pyramid, the pyramid's gradients (the sampling's adjoint: the gathers'
    scatter-add backward on the CPU, the adjoint kernel on the card), every
    parameter's gradient: the decoder's from the loss, the backbone's
    (ResNet + FPN) from ``upstream``, another run's pyramid gradients, or
    else this run's own), on the host."""
    from skghoi_torch.detect.adamixer import set_loss

    pyramid = model.backbone((images.float() - model.mean) / model.std)
    out = model.decoder(pyramid, tuple(images.shape[1:3]))
    loss = set_loss(out, assign, gt[0].to(out.boxes.dtype), *gt[1:], hw)["set_loss"]
    dec = list(model.decoder.named_parameters())
    g = torch.autograd.grad(loss, [*pyramid, *(p for _, p in dec)], retain_graph=True)
    up = g[:len(pyramid)] if upstream is None else [
        u.to(p.device, p.dtype) for u, p in zip(upstream, pyramid)]
    bb = list(model.backbone.named_parameters())
    bg = torch.autograd.grad(pyramid, [p for _, p in bb], grad_outputs=up)
    grads = {f"decoder.{n}": x.detach().cpu() for (n, _), x in zip(dec, g[len(pyramid):])}
    grads.update({f"backbone.{n}": x.detach().cpu() for (n, _), x in zip(bb, bg)})
    return (loss.item(), [x.detach().cpu() for x in pyramid],
            [x.detach().cpu() for x in g[:len(pyramid)]], grads)


def stage1_adamixer(images, gt):
    """Phase 13b: AdaMixer card against CPU on one image (the CPU model takes
    the card's weights; assignments computed once on the CPU and fed to
    both) at init and after the train steps: per-stage logits and boxes and
    the set loss in float32, then both models in float64 for one backward
    split at the pyramid (see ``S1_GRAD64_TOL``), the two float64 pyramids
    held first (``S1_PYR64_TOL``): at init every backbone
    gradient from the CPU's pyramid gradients; after training the set loss,
    the pyramid's gradients (the gathers' scatter-add backward on the CPU,
    the sampling's adjoint kernel on the card) and every decoder gradient.
    Between the two, ``S1_ADAMIXER_STEPS`` train steps at batch
    ``S1_BATCH``, each launching the sampling kernels once each way a stage
    (counted from zero, reported a step in the kernels line).  At
    init every stage keeps the whole-image box (``fc_reg`` starts at zero),
    so the outputs are held again after training."""
    from skghoi_torch.detect.adamixer import AdaMixerDetector, compute_assignments, set_loss
    from skghoi_torch.ops.adamixer_sample_cuda import sample_cuda
    from skghoi_torch.tools.train_detector import _first_occurrence_mask, adamw, build_adamixer_step

    out = {}
    boxes, labels, valid = gt
    valid = torch.from_numpy(_first_occurrence_mask(boxes.cpu().numpy(), labels.cpu().numpy(),
                                                    valid.cpu().numpy())).cuda()
    hw = (float(CANVAS[0]), float(CANVAS[1]))
    card, cpu = AdaMixerDetector(device="cuda"), AdaMixerDetector(device="cpu")
    image, one = images[:1], (boxes[:1], labels[:1], valid[:1])
    cpu_image, cpu_one = image.cpu(), [t.cpu() for t in one]

    def card_vs_cpu(part):
        """The card's weights on both -> float32 and float64 differences of
        the ``part`` (``backbone.`` or ``decoder.``) gradients."""
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()}, strict=True)
        with torch.no_grad():
            got, want = card(image), cpu(cpu_image)
            assign = torch.from_numpy(compute_assignments(want, *cpu_one, hw))
            lg, lw = (set_loss(o, assign, *t, hw)["set_loss"].item()
                      for o, t in ((got, one), (want, cpu_one)))
        res = dict(logits_rel=[_rel(g, w) for g, w in zip(got.cls_logits, want.cls_logits)],
                   boxes_rel=[_rel(g, w) for g, w in zip(got.boxes, want.boxes)],
                   boxes_moved_px=(want.boxes[-1] - want.boxes[0]).abs().max().item(),
                   set_loss_rel=abs(lg - lw) / abs(lw))
        lw, fw, pyr_w, grads_w = _adamixer_grads(
            _float64_copy(cpu), cpu_image, assign, cpu_one, hw)
        lg, fg, pyr_g, grads_g = _adamixer_grads(
            _float64_copy(card), image, assign, one, hw, pyr_w)
        res["pyramid64_rel"] = [_rel(g, w) for g, w in zip(fg, fw)]
        if max(res["pyramid64_rel"]) > S1_PYR64_TOL:
            raise AssertionError(f"AdaMixer ({part}): the float64 pyramids card vs CPU "
                                 f"{res['pyramid64_rel']} (tol {S1_PYR64_TOL:g}): a float64 copy "
                                 f"computes below float64")
        rel = {n: r for n, r in _grad_rel(grads_g, grads_w).items() if n.startswith(part)}
        res.update(set_loss64_rel=abs(lg - lw) / abs(lw), gradients=len(rel),
                   grad_rel=max(rel.values()), grad_rel_at=max(rel, key=rel.get),
                   pyramid_grad_rel=[_rel(g, w) for g, w in zip(pyr_g, pyr_w)])
        if (max(res["logits_rel"] + res["boxes_rel"]) > S1_ADAMIXER_TOL
                or res["set_loss_rel"] > S1_LOSS_RTOL or res["grad_rel"] > S1_GRAD64_TOL):
            raise AssertionError(f"AdaMixer card vs CPU ({part}): {res}")
        return res

    out["init"] = card_vs_cpu("backbone.")
    optimizer = adamw(card, 1e-4, 1e-4)
    step = build_adamixer_step(card, optimizer)
    losses = []
    sample_cuda.launches = sample_cuda.backward_calls = 0
    for _ in range(S1_ADAMIXER_STEPS):
        losses.append(step(images, boxes, labels, valid)["set_loss"].item())
    # The sampling kernels, a step: one launch each way a decoder stage.
    out["sample_launches"] = sample_cuda.launches / len(losses)
    out["sample_backward_launches"] = sample_cuda.backward_calls / len(losses)
    stages = card.decoder.num_stages
    if (out["sample_launches"], out["sample_backward_launches"]) != (stages, stages):
        raise AssertionError(f"AdaMixer train step: {sample_cuda.launches} forward and "
                             f"{sample_cuda.backward_calls} adjoint sampling launches in "
                             f"{len(losses)} steps, expected {stages} each a step")
    out["losses"] = losses
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"AdaMixer train step losses {losses}")
    out.update(card_vs_cpu("decoder."))
    out["gt_boxes"] = int(valid[:1].sum())
    if (out["init"]["gradients"] + out["gradients"] != len(list(cpu.parameters()))
            or max(out["pyramid_grad_rel"]) > S1_GRAD64_TOL or out["set_loss64_rel"] > S1_GRAD64_TOL
            or not out["gt_boxes"]):
        raise AssertionError(f"AdaMixer card vs CPU after training: {out}")
    return out


def adamixer_check(runs=1):
    """Phase 13b alone, ``runs`` times on one batch, TF32 off as ``main``
    sets it: one JSON line a run with the card-vs-CPU readings at init and
    after training, or the error the run raised; raises at the end if any
    run failed.

        python3 -c "import chip_smoke as c; c.adamixer_check(10)"
    """
    import tempfile

    from skghoi_torch.data.synthetic import make_synthetic_hicodet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    keys = ("pyramid64_rel", "logits_rel", "boxes_rel", "set_loss_rel", "set_loss64_rel",
            "pyramid_grad_rel", "grad_rel", "grad_rel_at")
    failed = 0
    with tempfile.TemporaryDirectory(prefix="skghoi_s1_") as root:
        make_synthetic_hicodet(root, "train2015", num_images=DET_TRAIN_IMAGES)
        write_coco_to_hico(root)
        images, gt = _detector_batch(root, S1_BATCH)
        for i in range(runs):
            t0 = time.perf_counter()
            try:
                a = stage1_adamixer(images, gt)
                line = dict(init={k: a["init"][k] for k in keys}, after={k: a[k] for k in keys},
                            losses=a["losses"], sample_launches=a["sample_launches"],
                            sample_backward_launches=a["sample_backward_launches"])
            except AssertionError as e:
                failed += 1
                line = dict(error=str(e))
            log(json.dumps(dict(run=i, seconds=time.perf_counter() - t0, **line)))
    if failed:
        raise AssertionError(f"AdaMixer check: {failed} of {runs} runs failed")


def stage1_detr(root):
    """Phase 13c: a seeded random facebookresearch-layout DETR-R50 ``.pt``
    through ``preprocess_detections --detector detr`` over 8 landscape and 4
    portrait images; one image card against CPU."""
    from skghoi_torch.detect.detr import DETR, load_torch_detr, random_state_dict
    from skghoi_torch.tools import preprocess_detections
    from skghoi_torch.tools.preprocess_detections import detector_input
    from skghoi_torch.data.hicodet import HICODet

    out = {}
    sd = random_state_dict(0)
    ckpt = os.path.join(root, "detr_r50.pt")
    torch.save(sd, ckpt)
    cache = os.path.join(root, "detr_detections")
    wall, n_images = 0.0, 0
    for part, n in (("train2015", DET_TRAIN_IMAGES), ("test2015", DET_PORTRAIT_IMAGES)):
        t0 = time.perf_counter()
        run_cli(preprocess_detections.main, ["--data-root", root, "--partition", part,
                                             "--ckpt-path", ckpt, "--detector", "detr",
                                             "--cache-dir", cache, "--score-thresh",
                                             DET_SCORE_THRESH])
        wall += time.perf_counter() - t0
        n_images += n
        files = sorted(os.listdir(os.path.join(cache, part)))
        if len(files) != n:
            raise AssertionError(f"preprocess_detections --detector detr {part}: {len(files)} files")
        for name in files:
            with open(os.path.join(cache, part, name)) as f:
                det = json.load(f)
            if not det["boxes"] or not all(0 <= l < 80 for l in det["labels"]):
                raise AssertionError(f"DETR cache {part}/{name}: {len(det['boxes'])} boxes")
    out.update(images=n_images, cli_s=wall, images_per_s=n_images / wall,
               ms_per_image=wall * 1e3 / n_images)

    ds = HICODet(os.path.join(root, "hico_20160224_det/images/train2015"),
                 os.path.join(root, "instances_train2015.json"))
    padded, _, _ = detector_input(np.asarray(ds[0][0], np.float32) / 255.0)
    image = torch.from_numpy(padded)[None]
    card, cpu = DETR(device="cuda"), DETR(device="cpu")
    card.load_state_dict(load_torch_detr(sd), strict=True)
    cpu.load_state_dict(load_torch_detr(sd), strict=True)
    with torch.no_grad():
        got, want = card.raw(image.cuda()), cpu.raw(image)
        ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card.raw(image.cuda())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    out.update(logits_rel=_rel(got[0], want[0]), boxes_rel=_rel(got[1], want[1]),
               model_ms=sorted(ms[1:])[1])
    if out["logits_rel"] > S1_DETR_TOL or out["boxes_rel"] > S1_DETR_TOL:
        raise AssertionError(f"DETR card vs CPU: {out}")
    return out


def stage1_chain(root):
    """Phase 13d: the AdaMixer two-stage chain (``tests/test_cli_pipeline.py``):
    ``train_detector --synthetic --arch adamixer`` -> ``preprocess_detections
    --detector adamixer`` on its last ``.pt`` -> ``train_hicodet --synthetic``
    for one epoch on those caches, counting the kernel's launches there."""
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda
    from skghoi_torch.tools import preprocess_detections, train_detector, train_hicodet

    synth, det_ck = os.path.join(root, "chain"), os.path.join(root, "chain_ck")
    t0 = time.perf_counter()
    result, text = run_cli(train_detector.main, ["--synthetic", "--synthetic-root", synth,
                                                 "--arch", "adamixer", "--cache-dir", det_ck])
    train_s = time.perf_counter() - t0
    losses = [step["set_loss"] for step in result["losses"]]
    if ("Detector training complete." not in text or not losses
            or not all(map(math.isfinite, losses)) or len(result["checkpoints"]) != 2):
        raise AssertionError(f"train_detector --arch adamixer: losses {losses}")
    t0 = time.perf_counter()
    cache, _ = run_cli(preprocess_detections.main, [
        "--partition", "train2015", "--data-root", synth, "--cache-dir",
        os.path.join(root, "chain_dets"), "--ckpt-path", result["checkpoints"][-1], "--detector",
        "adamixer", "--score-thresh", DET_SCORE_THRESH, "--min-size", "64", "--max-size", "96",
        "--canvas", "64", "96"])
    cache_s = time.perf_counter() - t0
    files = sorted(os.listdir(cache))
    if len(files) != DET_TRAIN_IMAGES:
        raise AssertionError(f"preprocess_detections --detector adamixer: {len(files)} files")
    roi_align_cuda.launches = 0
    engine, text = run_cli(train_hicodet.main, [
        "--synthetic", "--synthetic-root", synth, "--train-detection-dir", cache,
        "--box-score-thresh", "0", "--batch-size", "4", "--num-workers", "0", "--cache-dir",
        os.path.join(root, "chain_hoi")])
    launches = roi_align_cuda.launches
    hoi_losses = [v for step in engine.step_losses for v in step.values()]
    if ("Training complete." not in text or not launches or launches != engine.iteration
            or not all(map(math.isfinite, hoi_losses))):
        raise AssertionError(f"train_hicodet on the AdaMixer caches: {engine.iteration} steps, "
                             f"{launches} launches, losses {hoi_losses}")
    return dict(detector_losses=losses, detector_train_s=train_s, cache_s=cache_s,
                hoi_steps=engine.iteration, hoi_losses=engine.step_losses, launches=launches)


def _bf16_held(name, card, card_f32, cpu):
    """Phase 13e: one output of the bfloat16 model on the card against the
    bfloat16 model on the CPU, beside the card's float32 model on the same
    inputs, image by image (``S1_BF16_FACTOR``, ``S1_BF16_GAP_MAX``): per
    image the error, the gap and their ratio."""
    held = []
    for i in range(card.shape[0]):
        err, gap = _rel(card[i], cpu[i]), _rel(card[i], card_f32[i])
        if not (card.dtype == cpu.dtype == torch.float32 and torch.isfinite(card[i]).all()
                and err <= S1_BF16_FACTOR * gap and gap <= S1_BF16_GAP_MAX):
            raise AssertionError(f"{name} bf16 card vs CPU, image {i}: {err:.3e}, bf16 vs fp32 "
                                 f"gap {gap:.3e}, dtype {card.dtype}")
        held.append(dict(err=err, gap=gap, ratio=err / gap))
    return held


def stage1_detr_bf16(seed=0):
    """Phase 13e: ``bench.py --stage1``'s model on the card: DETR-R50 (91
    classes, 6+6 layers, 100 queries, random facebookresearch-layout weights
    and images from ``seed``) in bfloat16 at 832x1344, batch 8, beside the
    float32 model; the batch in bfloat16 card against CPU, image by image;
    the encoder's input float32 and ``input_proj``'s output bfloat16 on the
    card."""
    from skghoi_torch.detect.detr import DETR, load_torch_detr, random_state_dict

    sd = load_torch_detr(random_state_dict(seed))
    models = {}
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        models[name] = DETR(dtype=dt, device="cuda")
        models[name].load_state_dict(sd, strict=True)
    h, w = CANVAS
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.uniform(-1, 1, (DETR_BENCH_BATCH, h, w, 3))
                              .astype(np.float32)).cuda()
    out, seen = {}, {}
    card = models["bf16"]
    hooks = [card.encoder[0].register_forward_pre_hook(
                 lambda m, args: seen.__setitem__("encoder_in", args[0].dtype)),
             card.input_proj.register_forward_hook(
                 lambda m, args, o: seen.__setitem__("input_proj_out", o.dtype))]
    with torch.no_grad():
        got = card.raw(images)
        for hk in hooks:
            hk.remove()
        ref = models["fp32"].raw(images)
        del models, card
        t0 = time.perf_counter()
        cpu = DETR(dtype=torch.bfloat16, device="cpu")
        cpu.load_state_dict(sd, strict=True)
        want = cpu.raw(images.cpu())
        out["cpu_s"] = time.perf_counter() - t0
    out["logits"], out["boxes"] = (_bf16_held(f"DETR {n}", g, r, c) for n, g, r, c in
                                   zip(("logits", "boxes"), got, ref, want))
    out["ratio_max"] = max(x["ratio"] for k in ("logits", "boxes") for x in out[k])
    out["dtypes"] = {k: str(v) for k, v in seen.items()}
    if seen != {"encoder_in": torch.float32, "input_proj_out": torch.bfloat16}:
        raise AssertionError(f"DETR bf16 on the card: {seen}")
    return out


def phase_stage1():
    """Phase 13: the trainable stage-1 detectors at full width: FPNDetector
    and AdaMixer (card vs CPU, the train step at batch 4, 832x1344), DETR-R50
    through ``preprocess_detections --detector detr``, and the AdaMixer
    two-stage chain into ``train_hicodet``."""
    import tempfile

    from skghoi_torch.data.synthetic import make_synthetic_hicodet

    out = {}
    with tempfile.TemporaryDirectory(prefix="skghoi_s1_") as root:
        make_synthetic_hicodet(root, "train2015", num_images=DET_TRAIN_IMAGES)
        make_synthetic_hicodet(root, "test2015", num_images=DET_PORTRAIT_IMAGES,
                               image_size=(640, 480), seed=1)
        write_coco_to_hico(root)
        images, gt = _detector_batch(root, S1_BATCH)
        t0 = time.perf_counter()
        f = out["fpn"] = stage1_fpn(images, gt)
        f["phase_s"] = time.perf_counter() - t0
        log(f"[stage1] FPNDetector card vs CPU (one 832x1344 image, float32): logits "
            f"{f['logits_rel']:.3e}, deltas {f['deltas_rel']:.3e} (rel, tol {S1_LOGIT_TOL:g}); "
            f"losses {f['loss_rel']:.3e} (rtol {S1_LOSS_RTOL:g}); {f['gradients']} gradients, "
            f"largest {f['grad_rel']:.3e} of the tensor's largest (tol {S1_GRAD_TOL:g}), held to "
            f"float64 [card, CPU]: {f['grads_held_to_float64']}; decode: {f['pool_misses']} pool "
            f"misses, {f['flips']} flips of {f['detections']} detections, each a tie; a box moved "
            f"0.5 px on the card is refused")
        log(f"[stage1] FPNDetector train step, batch {S1_BATCH}, 832x1344 ({f['anchors']} anchors "
            f"an image): {[round(x, 3) for x in f['step_ms']]} ms, median {f['median_ms']:.3f} ms, "
            f"{f['img_per_s']:.3f} img/s; traced step {f['traced_ms']:.3f} ms, device busy "
            f"{f['device_busy_ms']:.3f} ms in {f['device_ops']} ops: idle {f['idle_share']:.1%}; "
            f"decode_detections one image {f['decode_ms']:.3f} ms ({f['decode_nms_steps']} NMS "
            f"steps)")
        t0 = time.perf_counter()
        a = out["adamixer"] = stage1_adamixer(images, gt)
        a["phase_s"] = time.perf_counter() - t0
        i = a["init"]
        log(f"[stage1] AdaMixer card vs CPU at init (one image): logits rel "
            f"{max(i['logits_rel']):.2e}, boxes {max(i['boxes_rel']):.2e}, set loss "
            f"{i['set_loss_rel']:.2e}; in float64: pyramid "
            f"{[f'{x:.2e}' for x in i['pyramid64_rel']]} (tol {S1_PYR64_TOL:g}), from the CPU's "
            f"pyramid gradients {i['gradients']} backbone gradients, largest {i['grad_rel']:.3e} "
            f"({i['grad_rel_at']}; tol {S1_GRAD64_TOL:g})")
        log(f"[stage1] AdaMixer card vs CPU after its {len(a['losses'])} train steps (one image, "
            f"100 queries, 6 stages): logits rel {[f'{x:.2e}' for x in a['logits_rel']]}, boxes "
            f"rel {[f'{x:.2e}' for x in a['boxes_rel']]} (tol {S1_ADAMIXER_TOL:g}; the last "
            f"stage's boxes {a['boxes_moved_px']:.3f} px from the first's); set loss on the CPU's "
            f"assignments {a['set_loss_rel']:.3e} (rtol {S1_LOSS_RTOL:g}), {a['gt_boxes']} GT; in "
            f"float64: pyramid {[f'{x:.2e}' for x in a['pyramid64_rel']]} (tol {S1_PYR64_TOL:g}), "
            f"set loss {a['set_loss64_rel']:.3e}, pyramid gradients "
            f"{[f'{x:.2e}' for x in a['pyramid_grad_rel']]}, {a['gradients']} decoder gradients, "
            f"largest {a['grad_rel']:.3e} ({a['grad_rel_at']}; tol {S1_GRAD64_TOL:g})")
        t0 = time.perf_counter()
        d = out["detr"] = stage1_detr(root)
        d["phase_s"] = time.perf_counter() - t0
        log(f"[stage1] preprocess_detections --detector detr (random DETR-R50 .pt, "
            f"{d['images']} images, float32): {d['cli_s']:.3f} s, {d['images_per_s']:.3f} "
            f"images/s, {d['ms_per_image']:.3f} ms an image with the tool's resize and JSON; the "
            f"model alone {d['model_ms']:.3f} ms an image; card vs CPU logits {d['logits_rel']:.3e}, "
            f"boxes {d['boxes_rel']:.3e} (rel, tol {S1_DETR_TOL:g})")
        t0 = time.perf_counter()
        c = out["chain"] = stage1_chain(root)
        c["phase_s"] = time.perf_counter() - t0
        log(f"[stage1] chain: train_detector --synthetic --arch adamixer "
            f"({len(c['detector_losses'])} steps, set_loss {c['detector_losses'][0]:.4f} -> "
            f"{c['detector_losses'][-1]:.4f}, {c['detector_train_s']:.2f} s) -> preprocess_detections "
            f"--detector adamixer ({c['cache_s']:.2f} s) -> train_hicodet --synthetic "
            f"({c['hoi_steps']} steps, roi_align launches {c['launches']})")
        t0 = time.perf_counter()
        d = out["detr_bf16"] = stage1_detr_bf16()
        d["phase_s"] = time.perf_counter() - t0
        log(f"[stage1] DETR bf16 card vs CPU ({DETR_BENCH_BATCH} images, 6+6 layers), image by "
            f"image, error over the card's bf16-vs-fp32 gap (tol {S1_BF16_FACTOR:g}): logits "
            f"{[round(x['ratio'], 3) for x in d['logits']]}, boxes "
            f"{[round(x['ratio'], 3) for x in d['boxes']]}; largest error logits "
            f"{max(x['err'] for x in d['logits']):.3e}, boxes "
            f"{max(x['err'] for x in d['boxes']):.3e}; encoder input {d['dtypes']['encoder_in']}, "
            f"input_proj {d['dtypes']['input_proj_out']}; the CPU's run {d['cpu_s']:.1f} s")
    return out


TOOLS_EXTRACT_BATCH = 4  # phase 14: extract_roi_features' default batch
TOOLS_FEATURE_TOL = 1e-4  # phase 14: card vs CPU, relative to the largest |value|
# phase 14: the forwards and train steps of one perf_report call: the first
# call, the FLOP count, one warm-up and the timed ones
PERF_REPORT_FORWARDS = 1 + 1 + 1 + 10
PERF_REPORT_STEPS = 1 + 1 + 1 + 5
NAVIGATOR_SCRIPT = "help\nclasses ride\ncounts\nobjects\nverbs\nimage 0\nbogus\nquit\n"


def tool_inputs(work):
    """What phase 14 reads: phase 8's synthetic HICO-DET, ``ckpt_02.pt`` and
    ``train_hicodet`` log, phase 9's ``train_kge`` rows and WN18RR-size KG,
    phase 12's Faster R-CNN JSON caches.  Run alone, the phase makes stand-ins
    in ``work``: the same data, a two-epoch ``train_hicodet``, one
    ``train_kge`` epoch, and the synthetic detection caches."""
    from skghoi_torch.data.synthetic import make_synthetic_hicodet
    from skghoi_torch.tools import train_hicodet

    got = dict(ARTEFACTS)
    if "hico" not in got:
        root = os.path.join(work, "hico")
        make_synthetic_hicodet(root, "train2015", num_images=CLI_TRAIN_IMAGES, image_size=(480, 640))
        make_synthetic_hicodet(root, "test2015", num_images=CLI_TEST_IMAGES, image_size=(640, 480))
        _, text = run_cli(train_hicodet.main, [
            "--data-root", root, "--train-detection-dir", os.path.join(root, "detections_train2015"),
            "--val-detection-dir", os.path.join(root, "detections_test2015"), "--num-epochs", "2",
            "--batch-size", str(BATCH), "--cache-dir", os.path.join(work, "ck")])
        with open(os.path.join(work, "train_hicodet.log"), "w") as f:
            f.write(text)
        got.update(hico=root, **{"ckpt_02.pt": os.path.join(work, "ck", "ckpt_02.pt"),
                                 "train_hicodet.log": os.path.join(work, "train_hicodet.log")})
    if "wn18rr" not in got:
        got["wn18rr"] = write_synthetic_kg(os.path.join(work, "wn18rr"), WN18RR, seed=1)
        got["kge_rows.jsonl"] = os.path.join(work, "kge_rows.jsonl")
        _, row, _ = run_train_kge(["--data", got["wn18rr"], "--example", "transe_wn18rr",
                                   "--epochs", "1"])
        with open(got["kge_rows.jsonl"], "w") as f:
            f.write(json.dumps(row) + "\n")
    if "detect" not in got:
        got["detect"] = got["hico"]
        got["detect_cache"] = os.path.join(got["hico"], "detections_train2015")
    else:
        got["detect_cache"] = os.path.join(got["detect"], "detections", "train2015")
    return got


def tools_extract(root, work):
    """(a) ``extract_roi_features`` at its default geometry, card vs CPU on
    the first batch, and the kernel against its plain version on the tool's
    own pooled boxes."""
    from skghoi_torch.data.factory import DataFactory, HOILoader, to_device
    from skghoi_torch.models.interaction_head import filter_detections
    from skghoi_torch.ops.roi_align import multiscale_roi_align
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda
    from skghoi_torch.tools import extract_roi_features

    card_dir, cpu_dir = os.path.join(work, "roi_card"), os.path.join(work, "roi_cpu")
    det_dir = os.path.join(root, "detections_train2015")
    roi_align_cuda.launches = 0
    t0 = time.perf_counter()
    count, _ = run_cli(extract_roi_features.main, [
        "--data-root", root, "--detection-dir", det_dir, "--partition", "train2015",
        "--output-dir", card_dir])
    extract_s = time.perf_counter() - t0
    launches = roi_align_cuda.launches
    batches = math.ceil(CLI_TRAIN_IMAGES / TOOLS_EXTRACT_BATCH)
    names = sorted(os.listdir(card_dir))
    if count != CLI_TRAIN_IMAGES or len(names) != count or launches != batches:
        raise AssertionError(f"extract_roi_features: {count} images, {len(names)} files, "
                             f"{launches} launches for {batches} batches")

    factory = DataFactory("hicodet", "train2015", root, det_dir)
    loader = HOILoader(factory, TOOLS_EXTRACT_BATCH, shuffle=False, with_targets=False)
    extract_roi_features.extract_features(extract_roi_features.seeded_backbone("cpu"), loader,
                                          cpu_dir, max_batches=1)
    worst = 0.0
    for name in sorted(os.listdir(cpu_dir)):
        got, want = np.load(os.path.join(card_dir, name)), np.load(os.path.join(cpu_dir, name))
        for key in ("boxes", "labels", "scores", "n_h"):
            if not np.array_equal(got[key], want[key]):
                raise AssertionError(f"extract_roi_features {name}: {key} differ card vs CPU")
        scale = max(np.abs(want["features"]).max(), 1e-30)
        err = np.abs(got["features"] - want["features"]).max() / scale
        worst = max(worst, float(err))
        if got["features"].shape != want["features"].shape or err > TOOLS_FEATURE_TOL:
            raise AssertionError(f"extract_roi_features {name}: features {err:.3e} of the largest")

    batch, _ = next(iter(loader))
    b = to_device(batch, "cuda")
    with torch.no_grad():
        feats = extract_roi_features.seeded_backbone("cuda")(b.images)
        boxes = filter_detections(b.det_boxes, b.det_labels, b.det_scores, b.det_valid).boxes
        boxes = boxes.contiguous()
        err = (roi_align_cuda(feats, boxes) - multiscale_roi_align(feats, boxes)).abs().max().item()
    if not err <= FP32_TOL * (1 + max(f.abs().max().item() for f in feats)):
        raise AssertionError(f"roi_align on extract_roi_features' boxes: {err:.3e}")
    log(f"[tools] extract_roi_features, float32, {CLI_TRAIN_IMAGES} images 480x640 -> "
        f"{CANVAS[0]}x{CANVAS[1]}, batch {TOOLS_EXTRACT_BATCH}: {extract_s:.3f} s, {len(names)} "
        f".npz files, roi_align launches {launches} ({batches} batches); first batch card vs CPU: "
        f"boxes, labels, scores, n_h equal, features {worst:.3e} of the largest (tolerance "
        f"{TOOLS_FEATURE_TOL:g}); kernel vs plain on the tool's boxes {tuple(boxes.shape)}: "
        f"{err:.3e}")
    return dict(images=count, seconds=extract_s, launches=launches, batches=batches,
                feature_rel_err=worst, kernel_err=err)


def tools_demo(root, ckpt, work, have_mpl):
    """(b) ``demo`` with phase 8's ``ckpt_02.pt`` on one portrait test image
    (1344x832), card vs CPU."""
    from skghoi_torch.data.factory import DataFactory
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda
    from skghoi_torch.tools import demo

    det_dir = os.path.join(root, "detections_test2015")
    png = os.path.join(work, "demo_overlay.png")
    argv = ["--data-root", root, "--detection-dir", det_dir, "--partition", "test2015",
            "--index", "0", "--model-path", ckpt, "--output", png]
    factory = DataFactory("hicodet", "test2015", root, det_dir)

    def run(device):
        if have_mpl:
            return demo.main(argv + (["--cpu"] if device == "cpu" else []))
        return demo.run(factory, 0, ckpt, torch.device(device))

    roi_align_cuda.launches = 0
    t0 = time.perf_counter()
    card, _ = run_cli(lambda _: run("cuda"), None)
    demo_s = time.perf_counter() - t0
    launches = roi_align_cuda.launches
    cpu, _ = run_cli(lambda _: run("cpu"), None)
    got, want = card["res"], cpu["res"]
    for key in ("pair_index", "prediction", "object"):
        if not np.array_equal(got[key], want[key]):
            raise AssertionError(f"demo: {key} differ card vs CPU")
    err = float(np.abs(got["scores"] - want["scores"]).max()) if len(want["scores"]) else 0.0
    if launches != 1 or err > 1e-4 or not card["pairs"] or (have_mpl and not os.path.exists(png)):
        raise AssertionError(f"demo: {launches} launches, scores {err:.3e} apart, "
                             f"{len(card['pairs'])} pairs")
    log(f"[tools] demo --model-path ckpt_02.pt, test image 0 ({factory.canvas_portrait[0]}x"
        f"{factory.canvas_portrait[1]} canvas), float32: {demo_s:.3f} s, {len(card['pairs'])} pairs, "
        f"roi_align launches {launches}; card vs CPU: pairs, verbs, objects equal, scores "
        f"{err:.3e} apart (tolerance 1e-4); overlay {'written' if have_mpl else 'not drawn'}")
    return dict(seconds=demo_s, pairs=len(card["pairs"]), launches=launches, score_err=err,
                overlay=have_mpl and os.path.exists(png))


def tools_visualise_detections(data_root, cache, work):
    """(c) ``visualise_detections`` on the detector's JSON caches, card vs CPU."""
    from skghoi_torch.tools import visualise_detections

    kept = {}
    for device in ("cuda", "cpu"):
        jpg = os.path.join(work, f"detections_{device}.jpg")
        kept[device], _ = run_cli(visualise_detections.main, [
            "--data-root", data_root, "--detection-root", cache, "--partition", "train2015",
            "--image-idx", "0", "--box-score-thresh", DET_SCORE_THRESH, "--out-file", jpg]
            + (["--cpu"] if device == "cpu" else []))
        if not os.path.getsize(jpg):
            raise AssertionError(f"visualise_detections wrote no JPEG on {device}")
    if not len(kept["cuda"][0]) or not all(np.array_equal(a, b)
                                           for a, b in zip(kept["cuda"], kept["cpu"])):
        raise AssertionError(f"visualise_detections: kept boxes differ card vs CPU "
                             f"({len(kept['cuda'][0])} vs {len(kept['cpu'][0])})")
    log(f"[tools] visualise_detections --box-score-thresh {DET_SCORE_THRESH} on the detector's "
        f"JSON: {len(kept['cuda'][0])} boxes kept after NMS on the card, equal to --cpu; JPEG written")
    return dict(kept=len(kept["cuda"][0]))


def tools_learning_curve(log_path, work, have_mpl):
    """(d) ``learning_curve`` on phase 8's ``train_hicodet`` stdout."""
    import re

    from skghoi_torch.tools import learning_curve

    epochs, train, val = learning_curve.parse_log(log_path)
    with open(log_path) as f:
        lines = re.findall(r"^Epoch: (\d+) \| training mAP: (\S+), .*validation mAP: (\S+), ",
                           f.read(), re.M)
    want = ([int(e) for e, _, _ in lines], [float(t) for _, t, _ in lines],
            [float(v) for _, _, v in lines])
    if (epochs, train, val) != want or epochs != [0, 1]:
        raise AssertionError(f"learning_curve: parsed {(epochs, train, val)}, Epoch lines {want}")
    if have_mpl:
        run_cli(learning_curve.main, [log_path, "--output", os.path.join(work, "curve.png")])
    log(f"[tools] learning_curve on train_hicodet's log: epochs {epochs}, train mAP {train}, "
        f"val mAP {val}, as the Epoch lines say")
    return dict(epochs=epochs, train_map=train, val_map=val)


def tools_perf_report(serving_img_s):
    """(e) ``perf_report``: bf16, batch 8, 832x1344."""
    from skghoi_torch.ops.roi_align_cuda import RoIAlignFunction, roi_align_cuda
    from skghoi_torch.tools import perf_report

    roi_align_cuda.launches = 0
    RoIAlignFunction.backward_calls = 0
    rep, _ = run_cli(lambda _: perf_report.report(BATCH, CANVAS), None)
    launches, adjoints = roi_align_cuda.launches, RoIAlignFunction.backward_calls
    if launches != PERF_REPORT_FORWARDS + PERF_REPORT_STEPS or adjoints != PERF_REPORT_STEPS:
        raise AssertionError(f"perf_report: {launches} launches, {adjoints} adjoints")
    for part in ("inference", "train"):
        sec = rep[part]
        if not (sec["seconds_per_step"] > 0 and sec["tflops_per_step"] > 0):
            raise AssertionError(f"perf_report {part}: {sec}")
    log(f"[tools] perf_report bf16 {CANVAS[0]}x{CANVAS[1]} batch {BATCH} on "
        f"{rep['device_kind']} (peak {rep['peak_bf16_flops']}): inference "
        f"{rep['inference']['images_per_sec']:.2f} img/s, {rep['inference']['tflops_per_step']:.4f} "
        f"TFLOP a step, MFU {rep['inference']['mfu']}, first call "
        f"{rep['inference']['first_call_seconds']} s; train {rep['train']['images_per_sec']:.2f} "
        f"img/s, {rep['train']['tflops_per_step']:.4f} TFLOP a step, MFU {rep['train']['mfu']}, "
        f"first call {rep['train']['first_call_seconds']} s; beside phase 4's {serving_img_s:.2f} "
        f"serving img/s; roi_align launches {launches}, adjoints {adjoints}")
    return rep, launches


def tools_stage_profile(eager_ms):
    """(f) ``stage_profile --part all``, and the kernel against its plain
    version on the head part's inputs."""
    from skghoi_torch.ops.roi_align import multiscale_roi_align
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda
    from skghoi_torch.tools import stage_profile

    prof, _ = run_cli(lambda _: stage_profile.profile(BATCH, CANVAS), None)
    feats, boxes = stage_profile.head_inputs(BATCH, CANVAS, torch.device("cuda"))
    with torch.no_grad():
        err = (roi_align_cuda(feats, boxes).float()
               - multiscale_roi_align(feats, boxes).float()).abs().max().item()
    if err > 1e-2:
        raise AssertionError(f"roi_align on stage_profile's head inputs: {err:.3e}")
    stages = ("backbone_fpn", "stem", "layer1", "layer2", "layer3", "layer4")
    if not all(prof[s][k] > 0 for s in stages for k in prof[s]) or prof["n_params"] <= 0:
        raise AssertionError(f"stage_profile: {prof}")
    log(f"[tools] stage_profile bf16 {CANVAS[0]}x{CANVAS[1]} batch {BATCH}: " + ", ".join(
        f"{s} fwd {prof[s]['fwd_ms']:.3f} ms / fwd+bwd {prof[s]['fwd_bwd_ms']:.3f} ms" for s in stages)
        + f"; AdamW {prof['adamw_plain_ms']:.3f} ms plain, {prof['adamw_guarded_ms']:.3f} ms "
        f"guarded over {prof['n_params_updated']} of {prof['n_params']} parameters; roi_align "
        f"forward {prof['roi_fwd_ms']:.4f} ms (beside phase 2's eager call {eager_ms:.4f} ms), "
        f"forward+adjoint {prof['roi_fwd_bwd_ms']:.4f} ms; kernel vs plain on the head inputs "
        f"{tuple(boxes.shape)} bf16: {err:.3e} (1e-2)")
    return prof


def tools_bench_io(root, cli_train_img_s):
    """(g) ``bench_io --train`` on phase 8's 16 landscape images."""
    from skghoi_torch.ops.roi_align_cuda import RoIAlignFunction, roi_align_cuda
    from skghoi_torch.tools import bench_io

    roi_align_cuda.launches = 0
    RoIAlignFunction.backward_calls = 0
    res, _ = run_cli(bench_io.main, ["--num-images", str(CLI_TRAIN_IMAGES), "--epochs", "2",
                                     "--batch-size", str(BATCH), "--train", "--root", root])
    steps = 2 * math.ceil(CLI_TRAIN_IMAGES / BATCH)
    if (res["loader"]["num_images"] != CLI_TRAIN_IMAGES or res["loader"]["platform"] != "cuda"
            or roi_align_cuda.launches != steps or RoIAlignFunction.backward_calls != steps):
        raise AssertionError(f"bench_io: {res}, {roi_align_cuda.launches} launches")
    log(f"[tools] bench_io 480x640 -> {CANVAS[0]}x{CANVAS[1]}, batch {BATCH}, 2 epochs: loader "
        f"{res['loader']['imgs_per_s']} img/s (epochs {res['loader']['epoch_imgs_per_s']}); "
        f"--train {res['train_e2e']['imgs_per_s']} img/s with the loader (epochs "
        f"{res['train_e2e']['epoch_imgs_per_s']}), beside phase 8's {cli_train_img_s:.2f} CLI-path "
        f"train img/s; roi_align launches {roi_align_cuda.launches} in {steps} steps")
    return res


def tools_host(inputs, ckpt, work, have_mpl):
    """(h) The host tools once: ``hicodet_split``, ``navigator`` (scripted
    stdin), ``generate_html_page``, ``kge_results_table`` (phase 9's rows),
    ``kge_relation_stats`` (phase 9's WN18RR-size KG), ``visualise_and_cache``
    (``.mat`` files that ``cache_results --dataset hicodet`` writes with
    ``ckpt_02.pt``) and ``text_label``."""
    import io

    import scipy.io as sio

    from skghoi_torch.data import hico_meta, text_label
    from skghoi_torch.tools import (cache_results, generate_html_page, hicodet_split,
                                    kge_relation_stats, kge_results_table, navigator,
                                    visualise_and_cache)

    root = inputs["hico"]
    out = {}
    split = os.path.join(work, "split.json")
    run_cli(hicodet_split.main, ["--data-root", root, "--output", split])
    with open(split) as f:
        pools = json.load(f)
    out["split"] = [len(pools["train"]), len(pools["val"])]

    stdin, sys.stdin = sys.stdin, io.StringIO(NAVIGATOR_SCRIPT)
    try:
        _, text = run_cli(navigator.main, ["--data-root", root])
    finally:
        sys.stdin = stdin
    out["navigator_lines"] = len(text.splitlines())

    _, text = run_cli(generate_html_page.main, [
        os.path.join(root, "hico_20160224_det/images/train2015"), "--output",
        os.path.join(work, "gallery.html"), "--per-page", "8"])
    out["html_pages"] = len([f for f in os.listdir(work) if f.startswith("gallery")])

    _, table = run_cli(kge_results_table.main, [inputs["kge_rows.jsonl"]])
    out["kge_table_rows"] = len(table.splitlines()) - 2

    stats = os.path.join(work, "nn")
    run_cli(kge_relation_stats.main, ["--data", inputs["wn18rr"], "--output-dir", stats])
    counts = {}
    for name in sorted(os.listdir(stats)):
        with open(os.path.join(stats, name)) as f:
            counts[name] = int(f.readline())
    out["relation_stats"] = counts

    mats = os.path.join(work, "mat")
    run_cli(cache_results.main, [
        "--dataset", "hicodet", "--data-root", root, "--partition", "test2015",
        "--detection-dir", os.path.join(root, "detections_test2015"), "--model-path", ckpt,
        "--cache-dir", mats, "--batch-size", str(BATCH)])
    found = next((o, r) for o in range(80)
                 for r in range(sio.loadmat(os.path.join(mats, f"detections_{o:02d}.mat"))
                                ["all_boxes"].shape[0])
                 if len(visualise_and_cache.ranked_scores(mats, o, r)[1]))
    _, scores = visualise_and_cache.ranked_scores(mats, *found)
    if have_mpl:
        run_cli(visualise_and_cache.main, ["--cache-dir", mats, "--object", str(found[0]),
                                           "--row", str(found[1]), "--num-gt", "5",
                                           "--output", os.path.join(work, "pr.png")])
    out["mat_scores"] = int(len(scores))

    corr = [(i, o, v) for i, (v, o) in enumerate(hico_meta.HICO_INTERACTIONS)]
    prompts = text_label.hico_text_labels(corr, hico_meta.HICO_VERBS, hico_meta.HICO_OBJECTS)
    objects = text_label.hico_obj_text_labels(hico_meta.HICO_OBJECTS)
    out["text_label"] = [len(prompts), len(objects)]
    if (out["split"] != [CLI_TRAIN_IMAGES // 2] * 2 or out["navigator_lines"] < 200
            or out["html_pages"] != 2 or out["kge_table_rows"] < 1
            or sum(counts.values()) < WN18RR["test"] or not scores.size
            or out["text_label"] != [600, 81]):
        raise AssertionError(f"host tools: {out}")
    log(f"[tools] host tools: hicodet_split {out['split']}, navigator {out['navigator_lines']} "
        f"lines for its script, generate_html_page {out['html_pages']} pages, kge_results_table "
        f"{out['kge_table_rows']} rows, kge_relation_stats {counts}, visualise_and_cache "
        f"{len(scores)} scores of object {found[0]} row {found[1]}, text_label {len(prompts)} pair "
        f"and {len(objects)} object prompts")
    return out


def phase_tools(serving_img_s, cli_train_img_s, eager_ms):
    """Phase 14: the user and measurement tools on the card, on what phases
    8, 9 and 12 left (or stand-ins when the phase runs alone)."""
    import importlib.util
    import tempfile

    have_mpl = importlib.util.find_spec("matplotlib") is not None
    log(f"[tools] matplotlib {'is' if have_mpl else 'is not'} installed: the overlays and plots "
        f"are {'drawn' if have_mpl else 'left out; the computing functions run'}")
    out = dict(matplotlib=have_mpl)
    with tempfile.TemporaryDirectory(prefix="skghoi_tools_") as work:
        t0 = time.perf_counter()
        inputs = tool_inputs(work)
        root, ckpt = inputs["hico"], inputs["ckpt_02.pt"]
        out["extract"] = tools_extract(root, work)
        out["demo"] = tools_demo(root, ckpt, work, have_mpl)
        out["visualise_detections"] = tools_visualise_detections(inputs["detect"],
                                                                 inputs["detect_cache"], work)
        out["learning_curve"] = tools_learning_curve(inputs["train_hicodet.log"], work, have_mpl)
        out["perf_report"], out["perf_report_launches"] = tools_perf_report(serving_img_s)
        out["stage_profile"] = tools_stage_profile(eager_ms)
        out["bench_io"] = tools_bench_io(root, cli_train_img_s)
        out["host"] = tools_host(inputs, ckpt, work, have_mpl)
        out["seconds"] = time.perf_counter() - t0
    log(f"[tools] phase 14 took {out['seconds']:.1f} s")
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
    ap.add_argument("--ddp-worker", nargs=2, metavar=("KIND", "OUT"), default=None,
                    help="phase 11's worker: run train_hicodet (hoi) or train_kge (kge) with the "
                         "arguments after --, write its results to OUT")
    args, tool_args = ap.parse_known_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.ddp_worker:
        return ddp_worker(*args.ddp_worker, [a for a in tool_args if a != "--"])
    import shutil
    import tempfile

    global KEEP_DIR
    KEEP_DIR = tempfile.mkdtemp(prefix="skghoi_keep_")
    try:
        return run_phases(args)
    finally:
        shutil.rmtree(KEEP_DIR, ignore_errors=True)


def run_phases(args) -> int:
    """Phases 1-16 in order; the result lines last."""
    from skghoi_torch.entry import make_batch
    from skghoi_torch.models.interaction_head import filter_detections
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    build_logged(roi_align_cuda, "roi_align")

    b = make_batch(BATCH, CANVAS, device="cuda")
    main_boxes = filter_detections(b.det_boxes, b.det_labels, b.det_scores, b.det_valid).boxes
    main_boxes = main_boxes.contiguous()
    kernel = phase_kernel(main_boxes)
    phase_parity()
    kernel["launches"], serving_img_s = phase_main(REQUESTS, args.profile)
    adjoint = phase_adjoint(main_boxes)
    phase_train_parity()
    train = phase_train()
    kernel["launches_train"] = train["launches"]
    adjoint["launches"] = train["adjoint_launches"]  # the training main path's
    cli = phase_cli()
    kernel["launches_cli"] = cli["launches"]
    kernel["launches_cli_test"] = cli["test_launches"]
    adjoint["launches_cli"] = cli["adjoint_launches"]
    kge = phase_kge()
    hoi = phase_vcoco_transh()
    kernel["launches_cli_vcoco"] = hoi["vcoco"]["launches"]
    kernel["launches_cli_transh"] = hoi["transh_init"]["launches"]
    ddp = phase_ddp()
    kernel["launches_ddp"] = ddp["hoi"]["launches_nccl"]
    adjoint["launches_ddp"] = ddp["hoi"]["adjoint_launches_nccl"]
    detect = phase_detect()
    landscape = next(v for k, v in detect["canvases"].items() if k.startswith("landscape"))
    kernel["launches_frcnn"] = detect["launches"]
    kernel["us_frcnn_cold"] = landscape["kernel"]["cold_ms"] * 1e3
    kernel["share_of_bound_frcnn"] = landscape["kernel"]["bound_ms"] / landscape["kernel"]["cold_ms"]
    spread = landscape["kernel_spread"]
    kernel["us_frcnn_spread_cold"] = spread["cold_ms"] * 1e3
    kernel["share_of_bound_frcnn_spread"] = spread["bound_ms"] / spread["cold_ms"]
    stage1 = phase_stage1()
    kernel["launches_adamixer_chain"] = stage1["chain"]["launches"]
    tools = phase_tools(serving_img_s, cli["train_img_per_s"], kernel["eager_ms"])
    kernel["launches_extract"] = tools["extract"]["launches"]
    kernel["launches_demo"] = tools["demo"]["launches"]
    kernel["launches_perf_report"] = tools["perf_report_launches"]
    frozen_bn = phase_frozen_bn()
    frozen_bn["launches_train"] = train["frozen_bn_launches"]  # a step, the training main path's
    frozen_bn["backward_launches_train"] = train["frozen_bn_backward_launches"]
    frozen_bn["launches_frcnn"] = detect["frozen_bn_launches"]  # an image
    sample = phase_adamixer_sample()
    sample["launches_train"] = stage1["adamixer"]["sample_launches"]  # a step, phase 13b's
    sample["backward_launches_train"] = stage1["adamixer"]["sample_backward_launches"]

    log(f"[card] {card}")
    print(json.dumps({"train": train}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"kge": kge}))
    print(json.dumps({"vcoco_transh": hoi}))
    print(json.dumps({"ddp": ddp}))
    print(json.dumps({"detect": detect}))
    print(json.dumps({"detectors": stage1}))
    print(json.dumps({"tools": tools}))
    print(json.dumps({"kernels": [kernel, adjoint, frozen_bn, sample]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

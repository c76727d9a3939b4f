#!/usr/bin/env python3
"""Drive the PyTorch port of the SCG HOI network on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Phases, each reporting on its own lines; any failure exits non-zero:

1. The card (``nvidia-smi`` name and power limit), and the build of the CUDA
   RoIAlign kernel from ``skghoi_torch/csrc`` into ``skghoi_torch/_build``.
2. The kernel against its plain PyTorch version on the card: the 832x1344
   FPN pyramid (C=256, batch 8) in float32 and bfloat16, on the 30 filtered
   box slots the main path gives it and on edge, degenerate and
   window-overflow boxes; then both timed with CUDA events.
3. The float32 network on the card against the same network on the CPU
   (64x96, batch 2; TF32 off): scores within 1e-4, filtered boxes and counts
   equal.
4. The main path: the bfloat16 network at full width, 832x1344, batch 8,
   answering ``REQUESTS`` forward requests with the launch counts set to 0
   just before; it checks the scores, that the kernel ran once per request,
   prints img/s, and holds the scores against the float32 network's.

It prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.
Without a CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12   # H100 SXM, outside the tensor cores
CANVAS = (832, 1344)
BATCH = 8
REQUESTS = 5  # main-path forward requests (the contract asks for at least 3)

EDGE_BOXES = [  # tests/test_pallas_roi_align.py: edge, extreme and overflow fixtures
    [0.0, 0.0, 383.0, 255.0], [-20.0, -20.0, 30.0, 30.0], [370.0, 240.0, 383.0, 255.0],
    [5.0, 5.0, 6.0, 6.0], [0.0, 0.0, 0.0, 0.0], [100.0, 50.0, 220.0, 200.0],
    [0.0, 100.0, 380.0, 112.0], [200.0, 0.0, 214.0, 250.0], [0.0, 0.0, 383.0, 30.0],
    [-10.0, -10.0, 390.0, 260.0], [50.0, 50.0, 51.0, 51.0],
    [100.0, 300.0, 1000.0, 400.0], [40.0, 700.0, 1340.0, 760.0], [200.0, 200.0, 400.0, 500.0],
    [0.0, 0.0, 1344.0, 832.0], [-50.0, -40.0, 1400.0, 900.0],
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


def graph_ms(fn, iters: int, per_graph: int = 20) -> float:
    """Device time per call of ``fn``: ``per_graph`` calls captured in one
    CUDA graph and replayed, so host launch cost is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return cuda_ms(graph.replay, iters) / per_graph


def roi_bound_ms(maps, boxes):
    """Least time for the kernel's work on these inputs: the larger of its
    bytes (distinct map cells the samples read, the boxes, levels and the
    output) over HBM bandwidth and its float32 operations over peak."""
    from skghoi_torch.ops.roi_align import _sample_axis, fpn_level_assignment

    bsz, n = boxes.shape[:2]
    c, elem = maps[0].shape[-1], maps[0].element_size()
    levels = fpn_level_assignment(boxes)
    cells, base = [], 0
    for l, (fm, stride) in enumerate(zip(maps, (4, 8, 16, 32))):
        h, w = fm.shape[1:3]
        x1, y1 = boxes[..., 0] / stride, boxes[..., 1] / stride
        roi_w = (boxes[..., 2] / stride - x1).clamp_min(1.0)
        roi_h = (boxes[..., 3] / stride - y1).clamp_min(1.0)
        yl, yh, *_ = _sample_axis(y1, roi_h, h, 7, 2)
        xl, xh, *_ = _sample_axis(x1, roi_w, w, 7, 2)
        ys, xs = torch.cat([yl, yh], -1), torch.cat([xl, xh], -1)  # [B, N, 28]
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


def phase_kernel(main_boxes):
    from skghoi_torch.ops.roi_align import multiscale_roi_align
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda

    g = torch.Generator(device="cuda").manual_seed(0)
    maps32 = [torch.randn(BATCH, CANVAS[0] // s, CANVAS[1] // s, 256, device="cuda", generator=g)
              for s in (4, 8, 16, 32)]
    edge = torch.tensor([EDGE_BOXES] * BATCH, device="cuda")
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        maps = [m.to(dtype) for m in maps32]
        for name, boxes in (("main", main_boxes), ("edge", edge)):
            got = roi_align_cuda(maps, boxes)
            want = multiscale_roi_align(maps, boxes)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != want.shape:
                raise AssertionError(f"kernel output {got.dtype} {tuple(got.shape)}")
            err = (got.float() - want.float()).abs().max().item()
            errs[(dtype, name)] = err
            ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
            log(f"[kernel] roi_align {str(dtype)[6:]} {name} boxes {tuple(boxes.shape)}: "
                f"max|kernel-plain| {err:.3e} (rtol=atol={tol:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"roi_align kernel disagrees with plain version ({dtype}, {name})")

    maps = [m.to(torch.bfloat16) for m in maps32]
    ms = graph_ms(lambda: roi_align_cuda(maps, main_boxes), iters=20)
    call_ms = cuda_ms(lambda: roi_align_cuda(maps, main_boxes), iters=200)
    plain_ms = cuda_ms(lambda: multiscale_roi_align(maps, main_boxes), iters=10)
    bound_ms, bound_by, touched = roi_bound_ms(maps, main_boxes)
    log(f"[kernel] roi_align bf16 B={BATCH} N={main_boxes.shape[1]} C=256: device {ms:.4f} ms "
        f"per call (CUDA graph: level assignment + kernel), eager call {call_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({touched} distinct cells read)")
    return dict(name="roi_align", route="cuda", source="skghoi_torch/csrc/roi_align.cu",
                replaces="skghoi_tpu/ops/pallas_roi_align.py:213",
                max_abs_err=errs[(torch.bfloat16, "main")],
                max_abs_err_fp32=max(v for (d, _), v in errs.items() if d == torch.float32),
                ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


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


@torch.no_grad()
def profile_forward(model, batch, ovm, profile_dir, request_s):
    """One traced forward (device busy time, kernel count, top ops) and the
    eager time of each stage of the path, by CUDA events."""
    from torch.autograd import DeviceType
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
    device = [e for e in events if e.device_type == DeviceType.CUDA]  # kernels, copies
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    n_kernels = sum(e.count for e in device)
    roi = [e for e in events if "roi_align_fwd_kernel" in e.key]
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from skghoi_torch.entry import make_batch
    from skghoi_torch.models.interaction_head import filter_detections
    from skghoi_torch.ops.roi_align_cuda import roi_align_cuda

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    roi_align_cuda.build()
    log(f"[build] roi_align.cu -> {roi_align_cuda.build_dir.name}/ in {roi_align_cuda.build_seconds:.2f} s")
    for line in roi_align_cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    b = make_batch(BATCH, CANVAS, device="cuda")
    main_boxes = filter_detections(b.det_boxes, b.det_labels, b.det_scores, b.det_valid).boxes
    kernel = phase_kernel(main_boxes.contiguous())
    phase_parity()
    kernel["launches"] = phase_main(REQUESTS, args.profile)

    log(f"[card] {card}")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

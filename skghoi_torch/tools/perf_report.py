"""Measured performance report: throughput, step time, FLOPs, and MFU.

    python -m skghoi_torch.tools.perf_report [--batch 8] [--no-train] [--trace DIR]

Mirrors ``skghoi_tpu.tools.perf_report``: it times the flagship SCG network's
bfloat16 inference forward and train step (``entry.make_batch`` /
``entry.verb_mask`` / ``parallel.train_step.build_train_step`` with the
reference two-group AdamW) at 832x1344 on the card, after one warm-up call,
counts their FLOPs and reports model FLOPs utilization against the card's
bf16 peak.  It runs on ``cuda`` unless ``device="cpu"`` is given, and raises
without a card.  Prints one JSON document; ``--trace`` also writes a
torch.profiler trace of a few steady-state calls (:func:`skghoi_torch.utils.trace`).

Differences from the JAX tool, which reads XLA's ``cost_analysis``:

- FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over one call
  (``flops_counted`` in the JSON says so): the convolutions and matrix
  products of the work, backward ones included, and none of the elementwise
  work, which XLA also counts.  The RoIAlign kernel, launched through
  ``ctypes``, is not seen (about 0.06% of a forward's operations).
- ``peak_bf16_flops`` is keyed on ``torch.cuda.get_device_name()``; a card
  not in :data:`PEAK_BF16`, or the CPU, reports ``null`` for it and for
  ``mfu``, never another device's peak.
- An eager program has no compile step: ``first_call_seconds`` stands where
  JAX has ``compile_seconds``.  It is the first call's wall time (cuDNN's
  algorithm search, the allocator's growth, the RoIAlign kernel's build if
  it was not built yet, and for the step AdamW's lazy state).
"""

from __future__ import annotations

import argparse
import json
import time

from skghoi_torch.device import synchronize

# Dense (no sparsity) bf16 tensor-core peak per card, in FLOP/s, keyed on
# torch.cuda.get_device_name().  Source: NVIDIA H100 Tensor Core GPU
# datasheet (SXM5: 1,979 TFLOP/s and PCIe: 1,513 TFLOP/s with sparsity,
# half that dense), at the card's full power limit.
PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.4e12,  # H100 SXM5
    "NVIDIA H100 PCIe": 756.5e12,
}

FLOPS_COUNTED = ("torch.utils.flop_counter.FlopCounterMode over one call: convolutions and "
                 "matrix products (forward and backward); no elementwise work; not the "
                 "ctypes-launched RoIAlign kernel")


def peak_for(device) -> float | None:
    import torch

    if device.type != "cuda":
        return None
    return PEAK_BF16.get(torch.cuda.get_device_name(device))


def _first_call(fn, device) -> float:
    t0 = time.perf_counter()
    fn()
    synchronize(device)
    return time.perf_counter() - t0


def _timed(fn, device, iters=10) -> float:
    """Steady-state seconds per call (after a warm-up call, synchronised)."""
    fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize(device)
    return (time.perf_counter() - t0) / iters


def count_flops(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _section(flops: float, seconds: float, batch_size: int, peak, first_s: float) -> dict:
    return {
        "seconds_per_step": seconds,
        "images_per_sec": batch_size / seconds,
        "tflops_per_step": flops / 1e12,
        "mfu": flops / seconds / peak if peak else None,
        "first_call_seconds": round(first_s, 1),
    }


def report(batch_size: int = 8, canvas=(832, 1344), include_train: bool = True,
           trace_dir: str | None = None, device=None) -> dict:
    import torch

    from skghoi_torch.device import resolve_device
    from skghoi_torch.entry import build_model, make_batch, verb_mask
    from skghoi_torch.parallel.train_step import build_train_step
    from skghoi_torch.train.optimizer import build_optimizer

    device = resolve_device(device)
    peak = peak_for(device)
    out: dict = {
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "peak_bf16_flops": peak,
        "batch_size": batch_size,
        "canvas": list(canvas),
        "flops_counted": FLOPS_COUNTED,
    }

    model = build_model(dtype=torch.bfloat16, device=device)
    ovm = verb_mask(device=device)
    batch = make_batch(batch_size, canvas, device=device)

    @torch.no_grad()
    def fwd():
        return model(batch, ovm).scores

    first_infer_s = _first_call(fwd, device)
    infer_flops = count_flops(fwd)
    t_infer = _timed(fwd, device)
    out["inference"] = _section(infer_flops, t_infer, batch_size, peak, first_infer_s)

    if include_train:
        train_batch = make_batch(batch_size, canvas, with_targets=True, device=device)
        step = build_train_step(model, build_optimizer(model), ovm)
        generator = torch.Generator(device=device).manual_seed(1)

        def train():
            return step(train_batch, generator)

        first_train_s = _first_call(train, device)
        train_flops = count_flops(train)
        t_train = _timed(train, device, iters=5)
        out["train"] = _section(train_flops, t_train, batch_size, peak, first_train_s)

    if trace_dir:
        from skghoi_torch.utils.profiling import trace

        with trace(trace_dir):
            for _ in range(3):
                fwd()
            if include_train:
                train()
        out["trace_dir"] = trace_dir
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--no-train", action="store_true")
    p.add_argument("--trace", default=None, help="write a torch.profiler trace here")
    args = p.parse_args(argv)
    print(json.dumps(report(args.batch, include_train=not args.no_train,
                            trace_dir=args.trace), indent=1))


if __name__ == "__main__":
    main()

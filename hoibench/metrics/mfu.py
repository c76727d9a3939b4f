"""The whole unit's share of the card's dense bfloat16 peak: the FLOPs of
one unit, counted by ``FlopCounterMode`` over the benchmark's reference at
the cell's shapes (convolutions and matrix products; RoIAlign, which bytes
bound, is gathers there and not counted), over the mean unit time of the
untraced window times the peak, in %."""

from collections import Counter

from hoibench.roofline import count_flops, peak


def read(ctx):
    top = peak(ctx.kind, "bf16_flops")
    if top is None:
        return None
    canvases = Counter(tuple(b.shape[1:3]) if hasattr(b, "shape") else b["images"].shape[1:3]
                       for b in ctx.driver.pool)
    flops = sum(n * count_flops(ctx.driver.flop_fn(c)) for c, n in canvases.items())
    flops /= sum(canvases.values())
    return flops / (ctx.driver.unit_s * top) * 100.0

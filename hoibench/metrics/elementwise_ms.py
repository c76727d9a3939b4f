"""Device ms a batch in PyTorch's elementwise kernels (frozen BatchNorm's
multiply-add, ReLU, the residual add, casts): the traced kernels whose name
holds one of ``PATTERNS``, summed, over the traced batches."""

PATTERNS = ("elementwise_kernel",)


def read(ctx):
    total = sum(b - a for n, a, b in ctx.trace.device if any(p in n for p in PATTERNS)) / 1e6
    if not total:
        return None
    return total / ctx.units * 1e3

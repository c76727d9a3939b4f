"""Device ms a unit in the program's FrozenBatchNorm kernels (the ResNet-50
body's BN, residual add and ReLU in one pass a site: device rows whose name
holds ``frozen_bn_``), summed over the traced units; None where none ran."""

PATTERN = "frozen_bn_"


def read(ctx):
    times = ctx.trace.kernels(PATTERN)
    if not times:
        return None
    return sum(times) / ctx.units * 1e3

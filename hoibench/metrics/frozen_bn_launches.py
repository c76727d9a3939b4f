"""Runs of the program's FrozenBatchNorm kernels (device rows whose name
holds ``frozen_bn_``, forward and backward) per traced unit: how often the
ResNet-50 body's fused BN epilogue engages; None where it never ran."""

PATTERN = "frozen_bn_"


def read(ctx):
    runs = len(ctx.trace.kernels(PATTERN))
    return runs / ctx.units if runs else None

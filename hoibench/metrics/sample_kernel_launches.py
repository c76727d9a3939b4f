"""Runs of the program's AdaMixer sampling kernels (device rows whose name
holds ``adamixer_sample_``, forward and adjoint) per traced step: whether the
decoder's sampling takes the kernels, one each way a stage; None where they
never ran (the eager gathers)."""

PATTERN = "adamixer_sample_"


def read(ctx):
    runs = len(ctx.trace.kernels(PATTERN))
    return runs / ctx.units if runs else None

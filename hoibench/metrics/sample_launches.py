"""Kernel launches the host issued under the program's ``skghoi.sample``
spans (each AdaMixer stage's adaptive 3D sampling in the forward: the
points' level weights, the tap indices and gathers of four levels) per
traced step; None where the program has no such span."""

from hoibench.spans import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx, ("sample",))

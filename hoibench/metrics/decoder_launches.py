"""Kernel launches the host issued under the program's ``skghoi.decoder``
span (``AdaMixerDecoder.forward``: the 6 stages' attention, sampling, mixing,
FFN and heads) per traced step; None where the program has no such span."""

from hoibench.spans import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx, ("decoder",))

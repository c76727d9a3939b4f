"""Device-idle ms a traced step whose gaps begin while the host is in the
program's ``skghoi.guard`` span (the NaN guard's host read, which waits for
the backward) or ``skghoi.optimizer`` (AdamW issued after it)."""

from hoibench.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, ("guard", "optimizer"))

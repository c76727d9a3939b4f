"""Device-idle ms a traced step whose gaps begin while the host is in the
program's ``skghoi.filter`` span (the detection filter and its NMS loop)."""

from hoibench.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, ("filter",))

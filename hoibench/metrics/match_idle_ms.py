"""Device-idle ms a traced step whose gaps begin while the host is in the
program's ``skghoi.match`` span (``compute_assignments``: the batched cost,
its copy to the host, which waits for the forward, and scipy's Hungarian of
each stage and image); None where the program has no such span."""

from hoibench.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, ("match",))

"""Device-idle ms a traced step whose gaps begin while the host is in the
program's ``skghoi.to_device`` span (pinning the collated batch and copying
it to the card)."""

from hoibench.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, ("to_device",))

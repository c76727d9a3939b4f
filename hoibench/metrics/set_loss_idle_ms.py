"""Device-idle ms a traced step whose gaps begin while the host is in the
program's ``skghoi.set_loss`` span (``train_detector``'s AdaMixer step: the
host's assignments copied to the card, then the set loss of every stage);
None where the program has no such span."""

from hoibench.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, ("set_loss",))

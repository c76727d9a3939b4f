"""Device-idle ms a traced step whose gaps begin while the host is in the
program's ``skghoi.ground_truth`` span (``train_detector.train_batch``: the
detector's ground truth from the batch's HOI pairs, and AdaMixer's
de-duplication, which copies it to the host and the mask back); None where
the program has no such span."""

from hoibench.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, ("ground_truth",))

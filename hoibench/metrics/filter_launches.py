"""Kernel launches the host issued under the program's ``skghoi.filter`` span
(``filter_detections``: the score threshold, the NMS loop, the sort, gathers
and pack) per traced step."""

from hoibench.spans import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx, ("filter",))

"""Share of the traced window (whole units) in which no operation ran on the
device: 1 - (union of device-operation intervals / the window), in %."""


def read(ctx):
    if not ctx.trace.device:
        return None
    return (1.0 - ctx.trace.busy_s / ctx.trace.window_s) * 100.0

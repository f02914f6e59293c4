"""Share of the traced window in which no operation ran on the device
(the frozen device_breakdown's arithmetic over the jobs of the window)."""


def read(ctx):
    if ctx.unit != "job" or ctx.trace is None or ctx.trace.wall_s <= 0:
        return None
    return 1 - ctx.trace.busy_s / ctx.trace.wall_s

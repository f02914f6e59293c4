"""The 95th percentile of every tick of the window, each from the update's
call to the refreshed model on the host."""

import statistics


def read(ctx):
    if ctx.unit != "tick" or len(ctx.samples) < 2:
        return None
    return statistics.quantiles(ctx.samples, n=100, method="inclusive")[94]

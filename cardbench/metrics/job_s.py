"""Seconds a job: the window over the whole jobs it completed, one after
another by one caller."""


def read(ctx):
    return ctx.window_s / ctx.n_units if ctx.unit == "job" and ctx.n_units else None

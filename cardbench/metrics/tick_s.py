"""Seconds a tick: the window over the ticks it completed, back to back."""


def read(ctx):
    return ctx.window_s / ctx.n_units if ctx.unit == "tick" and ctx.n_units else None

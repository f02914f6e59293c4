"""Seconds from the process's start to the window: imports, the card's
context, the kernel library, the data, the session, compiles and the warm
job."""


def read(ctx):
    return ctx.setup_s

"""Seconds to open the session on the tables (``connect``), synchronised."""


def read(ctx):
    return ctx.load_s

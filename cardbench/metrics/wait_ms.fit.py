"""Host milliseconds a fit in the program's ``tree.stats`` spans: each
level's statistics copied to the host, which waits there for the level's
pass to finish on the device."""


def read(ctx):
    spans = [s for s in ctx.window_spans if s["name"] == "tree.stats"]
    if ctx.unit != "job" or not spans or not ctx.n_units:
        return None
    return sum(s["dur"] for s in spans) * 1e-3 / ctx.n_units

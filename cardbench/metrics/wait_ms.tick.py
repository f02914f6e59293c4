"""Host milliseconds a tick in the program's ``ridge.results`` spans: every
maintained result copied to the host, which waits there for the tick's
device work to finish."""


def read(ctx):
    spans = [s for s in ctx.window_spans if s["name"] == "ridge.results"]
    if ctx.unit != "tick" or not spans or not ctx.n_units:
        return None
    return sum(s["dur"] for s in spans) * 1e-3 / ctx.n_units

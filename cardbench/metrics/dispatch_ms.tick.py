"""Host milliseconds a tick in the program's ``scan.step`` spans: each
delta scan step's payloads and kernel launches dispatched, with any time a
launch blocks on the device's full launch queue."""


def read(ctx):
    spans = [s for s in ctx.window_spans if s["name"] == "scan.step"]
    if ctx.unit != "tick" or not spans or not ctx.n_units:
        return None
    return sum(s["dur"] for s in spans) * 1e-3 / ctx.n_units

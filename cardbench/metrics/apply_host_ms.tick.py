"""Host milliseconds a tick inside the program's ``ivm.apply`` span
(validation, dispatch of the delta program and compaction, publish; the
span never waits for the device)."""


def read(ctx):
    spans = [s for s in ctx.window_spans if s["name"] == "ivm.apply"]
    if ctx.unit != "tick" or not spans or not ctx.n_units:
        return None
    return sum(s["dur"] for s in spans) * 1e-3 / ctx.n_units

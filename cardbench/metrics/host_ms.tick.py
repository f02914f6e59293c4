"""Host milliseconds a tick in the program's host work around the device:
the ``ivm.validate`` spans (the update checked on the host), ``ivm.stage``
(the delta padded, pinned and its copies enqueued) and ``ridge.solve``
(the covar assembled and solved on the host)."""

NAMES = ("ivm.validate", "ivm.stage", "ridge.solve")


def read(ctx):
    spans = [s for s in ctx.window_spans if s["name"] in NAMES]
    if (ctx.unit != "tick" or not ctx.n_units
            or {s["name"] for s in spans} != set(NAMES)):
        return None
    return sum(s["dur"] for s in spans) * 1e-3 / ctx.n_units

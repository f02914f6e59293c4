"""Host milliseconds a fit in the tree's own stepping: the program's
``tree.stage`` spans (the frontier's masks stacked into the pass's
params) and ``tree.split`` spans (costs, best splits and child masks from
a level's statistics).  Neither holds a launch or a wait."""

NAMES = ("tree.stage", "tree.split")


def read(ctx):
    spans = [s for s in ctx.window_spans if s["name"] in NAMES]
    if (ctx.unit != "job" or not ctx.n_units
            or {s["name"] for s in spans} != set(NAMES)):
        return None
    return sum(s["dur"] for s in spans) * 1e-3 / ctx.n_units

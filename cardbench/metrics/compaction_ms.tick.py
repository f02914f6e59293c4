"""Device milliseconds a tick in the resident relation's compaction and
append (the frozen ivm_group's compaction group)."""

from cardbench.metrics._profile import COMPACTION, grouped_ms, ivm_group


def read(ctx):
    if ctx.unit != "tick" or ctx.trace is None or not ctx.n_units:
        return None
    return grouped_ms(ctx.trace.by_name, ivm_group).get(COMPACTION, 0.0) / ctx.n_units

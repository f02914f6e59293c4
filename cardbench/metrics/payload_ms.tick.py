"""Device milliseconds a tick in kernels that are neither the port's own
nor the resident relation's compaction: the delta tuples' assembly, the
payloads' products and gathers, the state fold, copies."""

from cardbench.metrics._profile import grouped_ms, ivm_group


def read(ctx):
    if ctx.unit != "tick" or ctx.trace is None or not ctx.n_units:
        return None
    return grouped_ms(ctx.trace.by_name, ivm_group).get("other", 0.0) / ctx.n_units

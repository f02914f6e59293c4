"""Device milliseconds a job in kernels that are not the port's own: the
payloads' products and gathers, ``cat`` and copies."""

from cardbench.metrics._profile import grouped_ms, kernel_group


def read(ctx):
    if ctx.unit != "job" or ctx.trace is None or not ctx.n_units:
        return None
    return grouped_ms(ctx.trace.by_name, kernel_group).get("other", 0.0) / ctx.n_units

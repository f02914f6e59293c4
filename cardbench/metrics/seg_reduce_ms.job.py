"""Device milliseconds a job in the port's reductions (``seg_reduce::``
kernels: fused_scan_block, seg_aggregate, tree_hist*)."""

from cardbench.metrics._profile import SEG_REDUCE, grouped_ms, kernel_group


def read(ctx):
    if ctx.unit != "job" or ctx.trace is None or not ctx.n_units:
        return None
    return grouped_ms(ctx.trace.by_name, kernel_group).get(SEG_REDUCE, 0.0) / ctx.n_units

"""A job's least time on the chip over the device's busy time a job in the
traced window, in percent.  The least time is the larger of the bytes it
reads over the peak bandwidth and its operations over the float32 peak,
both counted from the job's definition (``_work_<kind>.py``), whatever
implements it.  Busy time is the sum of the window's kernel times, which
the profiler barely slows, where the traced window's wall is slowed by it;
the host's share of a job is ``idle_share.job``'s."""

import os

from cardbench.harness.spec import load_module
from cardbench.metrics._roofline import PEAK_BYTES_S, PEAK_F32_FLOP_S, bound


def read(ctx):
    path = os.path.join(os.path.dirname(__file__), f"_work_{ctx.kind}.py")
    if (ctx.unit != "job" or not ctx.n_units or ctx.trace is None
            or ctx.trace.busy_s <= 0 or not os.path.exists(path)):
        return None
    nbytes, ops = load_module(path).work(ctx.tables, ctx.info)
    b = bound(nbytes, ops, PEAK_BYTES_S, PEAK_F32_FLOP_S)
    ctx.notes["roofline_busy.job"] = f"bound by {b['bound_by']}: {nbytes} bytes, {ops} operations"
    return 100 * b["bound_ms"] * 1e-3 / (ctx.trace.busy_s / ctx.n_units)

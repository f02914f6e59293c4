"""The port's reduction launches against the chip, in percent: the least
time of every launch of the window, each the larger of its bytes over the
peak bandwidth and its operations over the float32 peak, as the program's
``kernel.*`` spans count them (each input read once, the output written
once, one add per row and output column), over the window's device time in
those kernels (``seg_reduce::``, the frozen kernel_group)."""

from cardbench.metrics._profile import SEG_REDUCE, grouped_ms, kernel_group
from cardbench.metrics._roofline import PEAK_BYTES_S, PEAK_F32_FLOP_S, bound


def share(ctx, name):
    """The share over the window, or None where no launch span carries its
    work or the trace has no reduction time."""
    work = [s["args"] for s in ctx.window_spans
            if s["name"].startswith("kernel.") and "bytes" in s.get("args", {})]
    if ctx.trace is None or not work:
        return None
    device_ms = grouped_ms(ctx.trace.by_name, kernel_group).get(SEG_REDUCE, 0.0)
    if device_ms <= 0:
        return None
    least = [bound(a["bytes"], a["ops"], PEAK_BYTES_S, PEAK_F32_FLOP_S) for a in work]
    ctx.notes[name] = {"launches": len(work), "bytes": sum(a["bytes"] for a in work),
                       "ops": sum(a["ops"] for a in work),
                       "bound_ms": sum(b["bound_ms"] for b in least),
                       "by_bytes": sum(b["bound_by"] == "bytes" for b in least),
                       "device_ms": device_ms}
    return 100 * ctx.notes[name]["bound_ms"] / device_ms


def read(ctx):
    if ctx.unit != "job":
        return None
    return share(ctx, "kernel_roofline.job")

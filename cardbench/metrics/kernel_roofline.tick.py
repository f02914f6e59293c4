"""``kernel_roofline.job``'s share over the ticks of the window: the least
time of the delta scans' reduction launches over their device time."""

import os

from cardbench.harness.spec import load_module

_job = load_module(os.path.join(os.path.dirname(__file__), "kernel_roofline.job.py"))


def read(ctx):
    if ctx.unit != "tick":
        return None
    return _job.share(ctx, "kernel_roofline.tick")

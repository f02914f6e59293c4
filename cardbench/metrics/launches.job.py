"""Launches of the port's kernels a job (``repro_torch.kernels.ops``'s
counters over the window)."""


def read(ctx):
    if ctx.unit != "job" or ctx.launches is None or not ctx.n_units:
        return None
    return sum(ctx.launches.values()) / ctx.n_units

"""The backward compositor's share of its roofline, in %: its least time
per step (benchmark/counts.py, at the needed pairs the reference found
on the same views) over the device time of ``composite_bwd_kernel`` per
step in the traced stretch. Read in a cell whose kind's check gives the
bound (``composite_bwd_bound_ms``: the train kind's)."""


def read(ctx):
    bound_ms = getattr(ctx, "composite_bwd_bound_ms", None)
    if bound_ms is None or ctx.profile is None:
        return None
    dev_s = ctx.profile.device_s(r"composite_bwd_kernel") / ctx.profile.units
    if dev_s <= 0:
        return None
    return 100.0 * bound_ms / 1e3 / dev_s

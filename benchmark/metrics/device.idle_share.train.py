"""The share of the traced stretch's wall time in which no kernel, copy
or memset ran on the card (torch.profiler), in %."""


def read(ctx):
    if ctx.profile is None or ctx.profile.wall_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.profile.busy_s / ctx.profile.wall_s)

"""The refinement's Adam (``engine/refine.py``'s ``unet_update``): the
device ms per epoch of the work launched inside its span in the traced
stretch of the window's own epochs (benchmark/tracing.py)."""


def read(ctx):
    if ctx.profile is None:
        return None
    s = ctx.profile.span_device_s("refine.adam")
    return 1e3 * s / ctx.profile.units if s > 0 else None

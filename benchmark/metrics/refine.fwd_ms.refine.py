"""The refinement's forward and loss (``engine/refine.py``'s
``unet_loss``: the masked input through the U-Net and the clipped BCE):
the device ms per epoch of the work launched inside its span in the
traced stretch of the window's own epochs (benchmark/tracing.py)."""


def read(ctx):
    if ctx.profile is None:
        return None
    s = ctx.profile.span_device_s("refine.forward")
    return 1e3 * s / ctx.profile.units if s > 0 else None

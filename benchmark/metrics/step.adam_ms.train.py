"""Per-group Adam (``engine/train.py``'s ``adam_step``): the device ms per
step of the work launched inside its span in the traced stretch of the
window's own calls (benchmark/tracing.py)."""


def read(ctx):
    if ctx.profile is None:
        return None
    s = ctx.profile.span_device_s("step.adam")
    return 1e3 * s / ctx.profile.units if s > 0 else None

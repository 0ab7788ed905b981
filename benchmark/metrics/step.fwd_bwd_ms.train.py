"""The step's value and gradient: the device ms per step of the work
launched inside the spans of ``engine/train.py``'s ``render`` and
``compute_losses`` and of ``torch.autograd.grad``, in the traced stretch
of the window's own calls (benchmark/tracing.py)."""

SPANS = ("step.render", "step.losses", "step.autograd")


def read(ctx):
    if ctx.profile is None:
        return None
    s = ctx.profile.span_device_s(*SPANS)
    return 1e3 * s / ctx.profile.units if s > 0 else None

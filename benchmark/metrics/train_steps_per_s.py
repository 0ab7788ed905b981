"""Training steps completed in the window per second of it: every step
of the window over the window's host-clock time, back to back, with one
synchronise at the end (host syncs and the enqueue count)."""


def read(ctx):
    return ctx.calls / ctx.window_s if ctx.kind == "train" else None

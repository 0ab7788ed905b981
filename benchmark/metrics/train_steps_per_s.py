"""Training steps completed in the window per second of it: every step
of the window over the window's host-clock time, back to back, with one
synchronise at the end (host syncs and the enqueue count). Reported in
the cells whose calls are training steps: the metric's ``workloads`` in
BENCHMARK.json."""


def read(ctx):
    return ctx.calls / ctx.window_s

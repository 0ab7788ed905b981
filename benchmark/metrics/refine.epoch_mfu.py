"""The whole refinement epoch's share of the chip's peak, in %: the least
time of the work one epoch's mathematics needs (benchmark/refine_counts.py:
the convolutions and the attention's products forward and backward in
float32 without tensor cores, which set it, beside the bytes of the
elementwise passes and Adam) over the measured time per epoch of the
window, taken before the profiler started. Read in a cell whose kind's
check counts the ``work`` of an epoch (the refine kind's)."""


def read(ctx):
    if ctx.work is None or not ctx.calls:
        return None
    return 100.0 * ctx.work.least_s() / (ctx.window_s / ctx.calls)

"""The whole step's share of the chip's peak, in %: the least time of
the work one step's mathematics needs (benchmark/counts.py step_work:
the render's activations, preprocess forward and backward, both
compositors at the needed pairs the reference found, the loss planes,
Adam over every group and the prior) over the measured time per step of
the window, taken before the profiler started. Read in a cell whose kind's
check counts the ``work`` of a step."""


def read(ctx):
    if ctx.work is None or not ctx.calls:
        return None
    return 100.0 * ctx.work.least_s() / (ctx.window_s / ctx.calls)

"""Binning's work: the (gaussian, tile) instances it made per training
step, from the program's own counters (``gslidar_tpu_torch/utils/
trace.py``'s ``instances`` and ``train_steps``, every step of the run).
A program without the counters reads nothing."""


def read(ctx):
    try:
        from gslidar_tpu_torch.utils.trace import counters
    except ImportError:
        return None
    c = counters()
    steps = c.get("train_steps", 0)
    return c.get("instances", 0) / steps if steps else None

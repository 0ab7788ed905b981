"""The host syncs of a training step: the program's own count of its
device-to-host reads (``gslidar_tpu_torch/utils/trace.py``'s counters
``host_syncs`` and ``train_steps``, every step of the run) per step. A
program without the counters reads nothing."""


def read(ctx):
    try:
        from gslidar_tpu_torch.utils.trace import counters
    except ImportError:
        return None
    c = counters()
    steps = c.get("train_steps", 0)
    return c.get("host_syncs", 0) / steps if steps else None

"""The host syncs of a refinement epoch: the program's own count of the
reads and blocking copies that wait for the card (``gslidar_tpu_torch/
utils/trace.py``'s counters ``host_syncs`` and ``refine_epochs``, every
epoch of the run) per epoch. A program without these counters reads
nothing."""


def read(ctx):
    try:
        from gslidar_tpu_torch.utils.trace import counters
    except ImportError:
        return None
    c = counters()
    epochs = c.get("refine_epochs", 0)
    return c.get("host_syncs", 0) / epochs if epochs else None

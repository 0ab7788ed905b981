"""torch.cuda.max_memory_allocated() over set-up, warm-up and window,
after a reset at the start of set-up, in GiB."""


def read(ctx):
    return ctx.peak_bytes / float(1 << 30) if ctx.peak_bytes else None

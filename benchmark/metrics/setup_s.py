"""Seconds from the start of the process to the first timed call:
imports, the card, the kernels' build or load, the seeded scene and
model, the checked first steps and the warm-up."""


def read(ctx):
    return ctx.setup_s

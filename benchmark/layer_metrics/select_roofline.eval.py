"""The select kernels' share of their roofline in sequence eval, %."""

from benchmark import readers


def read(ctx):
    return readers.select_roofline(ctx, "eval")

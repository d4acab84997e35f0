"""The select kernels' share of their roofline in training, %."""

from benchmark import readers


def read(ctx):
    return readers.select_roofline(ctx, "train")

"""The train step's dense products against the float32 peak, %."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, "train")

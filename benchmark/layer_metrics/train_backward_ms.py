"""Mean time from the train step's "forward" mark to its "backward" mark (CUDA events), ms."""

from benchmark import readers


def read(ctx):
    return readers.stage_ms(ctx, "train", "backward")

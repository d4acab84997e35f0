"""Mean time from the train step's "inputs" mark to its "forward" mark (CUDA events), ms."""

from benchmark import readers


def read(ctx):
    return readers.stage_ms(ctx, "train", "forward")

"""Mean time of the streaming eval's encode step (projection and tower; CUDA events), ms."""

from benchmark import readers


def read(ctx):
    return readers.stage_ms(ctx, "eval", "encode")

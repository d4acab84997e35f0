"""Mean time of the streaming eval's correlate step (correlation and refinement; CUDA events), ms."""

from benchmark import readers


def read(ctx):
    return readers.stage_ms(ctx, "eval", "correlate")

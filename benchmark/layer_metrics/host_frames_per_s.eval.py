"""Frames posed a second on the host's clock, over the window outside the profiled stretch."""

from benchmark import readers


def read(ctx):
    return readers.host_rate(ctx, "eval")

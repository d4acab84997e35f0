"""CUDA kernels a sequence-eval batch launches, from the profiled stretch."""

from benchmark import readers


def read(ctx):
    return readers.kernels_per_step(ctx, "eval")

"""Share of the profiled eval batches with no kernel running, %."""

from benchmark import readers


def read(ctx):
    return readers.device_idle(ctx, "eval")

"""Share of the profiled train steps with no kernel running, %."""

from benchmark import readers


def read(ctx):
    return readers.device_idle(ctx, "train")

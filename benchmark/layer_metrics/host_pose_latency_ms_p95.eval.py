"""95th percentile of the runner's time for a batch, from the previous batch's poses to this
batch's poses on the host, over the batches outside the profiled stretch, ms."""

from benchmark import readers


def read(ctx):
    return readers.host_tail(ctx, "eval")

"""Host microseconds of a train step (span ``train.step``) per CUDA kernel it launches."""

from benchmark import spans


def read(ctx):
    return spans.host_us_per_kernel(ctx, "train", ["train.step"])

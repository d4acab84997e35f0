"""Host microseconds of an eval batch's steps and splice (spans
``eval.encode``, ``eval.splice``, ``eval.correlate``) per CUDA kernel of
the batch."""

from benchmark import spans


def read(ctx):
    return spans.host_us_per_kernel(ctx, "eval",
                                    ["eval.encode", "eval.splice", "eval.correlate"])

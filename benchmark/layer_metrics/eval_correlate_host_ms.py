"""Mean host time of the streaming correlate step (span ``eval.correlate``), ms."""

from benchmark import spans


def read(ctx):
    return spans.mean_ms(ctx, "eval", "eval.correlate")

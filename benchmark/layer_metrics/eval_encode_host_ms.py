"""Mean host time of the streaming encode step (span ``eval.encode``: projection and tower), ms."""

from benchmark import spans


def read(ctx):
    return spans.mean_ms(ctx, "eval", "eval.encode")

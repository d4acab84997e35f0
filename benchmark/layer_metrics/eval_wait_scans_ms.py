"""Mean host time the sequence runner waits for its reader's next block
(span ``eval.wait_scans``), ms."""

from benchmark import spans


def read(ctx):
    return spans.mean_ms(ctx, "eval", "eval.wait_scans")

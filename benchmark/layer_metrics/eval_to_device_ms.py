"""Mean host time of a batch's int16 transfer to the card (span ``eval.to_device``), ms."""

from benchmark import spans


def read(ctx):
    return spans.mean_ms(ctx, "eval", "eval.to_device")

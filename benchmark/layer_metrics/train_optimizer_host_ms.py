"""Mean host time of the train step's optimizer stage (span ``train.optimizer``), ms."""

from benchmark import spans


def read(ctx):
    return spans.mean_ms(ctx, "train", "train.optimizer")

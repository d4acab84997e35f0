"""Mean host time of the train step's inputs stage (span ``train.inputs``:
the batch's copy to the card, preprocessing, projection), ms."""

from benchmark import spans


def read(ctx):
    return spans.mean_ms(ctx, "train", "train.inputs")

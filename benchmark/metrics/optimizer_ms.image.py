"""Milliseconds a traced step of the image model spends in
``train.optimizer`` (the optimizer's update and what follows it): the
device operations the host enqueued inside the span and the idle gaps
whose middle falls in it, over the ``train.step`` ranges in the window
(``benchmark.spans``)."""

from benchmark import spans

LAYER = "Image step: models/resnet.py, train.py"
UNIT = "ms"
MOVES = "images_per_s"


def read(reading):
    return spans.span_ms(reading, "train.optimizer")

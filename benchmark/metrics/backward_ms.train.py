"""Milliseconds a traced step of the LM spends in ``train.backward``
(the gradients, and their reductions on a mesh): the device operations
the host enqueued inside the span and the idle gaps whose middle falls
in it, over the ``train.step`` ranges in the window
(``benchmark.spans``)."""

from benchmark import spans

LAYER = "Train step: models/transformer.py, optim.py, ops/cross_entropy.py"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(reading):
    return spans.span_ms(reading, "train.backward")

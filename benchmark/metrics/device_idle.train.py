"""The share of the traced sub-window with no operation running on the
device, in percent."""

from benchmark import readers

LAYER = "Device: the card"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(reading):
    return readers.idle_percent(reading)

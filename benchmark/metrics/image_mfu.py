"""Images trained in the traced sub-window (over every rank), at 3 x
the forward's FLOPs an image (``counts.resnet_train_flops``), over the
sub-window's seconds, over the bf16 peak of the cards used: percent."""

from benchmark import counts, readers

LAYER = "Image step: models/resnet.py, train.py"
UNIT = "%"
MOVES = "images_per_s"


def read(reading):
    if reading is None or reading.trace is None \
            or "traced_images" not in reading.counts:
        return None
    c = reading.counts
    flops = counts.resnet_train_flops(c["config"], c["traced_images"])
    return readers.mfu_percent(flops / c.get("cards", 1),
                               reading.trace.window_s)

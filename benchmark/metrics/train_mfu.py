"""Tokens trained in the traced sub-window, at the benchmark's count
of FLOPs (``counts.lm_train_flops``: 6 x product parameters a token and
12 x layers x dim a live pair of each step's documents), over the
sub-window's seconds, over the bf16 peak: percent."""

from benchmark import counts, readers

LAYER = "Train step: models/transformer.py, optim.py, ops/cross_entropy.py"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(reading):
    if reading is None or reading.trace is None \
            or "traced_pairs" not in reading.counts:
        return None
    c = reading.counts
    tokens = len(c["traced_pairs"]) * c["batch"] * c["seq"]
    flops = counts.lm_train_flops(c["config"], tokens, sum(c["traced_pairs"]))
    return readers.mfu_percent(flops, reading.trace.window_s)

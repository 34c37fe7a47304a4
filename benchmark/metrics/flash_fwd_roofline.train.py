"""The attention forward's share of its roofline over the traced steps:
the least time (4 x dim a live pair against the bf16 peak, or q, k, v,
the output and the log-sum-exp once each against the bandwidth) over
the device time of the forward launches."""

from benchmark import counts, readers

LAYER = "Kernels: ops/, csrc/"
UNIT = "%"
MOVES = "train_tokens_per_s"
PATTERNS = ("flash_fwd_kernel",)


def read(reading):
    if reading is None or reading.trace is None \
            or "traced_pairs" not in reading.counts:
        return None
    return readers.share_percent(
        readers.flash_bound_s(reading, counts.flash_forward_work),
        reading.trace.seconds(PATTERNS))

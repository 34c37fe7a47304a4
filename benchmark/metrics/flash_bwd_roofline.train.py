"""The attention backward's share of its roofline over the traced
steps: the least time (8 x dim a live pair, no recomputed scores; or
q, k, v, the output, its gradient and the log-sum-exp read and dq, dk,
dv written once each) over the device time of the dq and dk/dv
launches."""

from benchmark import counts, readers

LAYER = "Kernels: ops/, csrc/"
UNIT = "%"
MOVES = "train_tokens_per_s"
PATTERNS = ("flash_dq_kernel", "flash_dkv_kernel")


def read(reading):
    if reading is None or reading.trace is None \
            or "traced_pairs" not in reading.counts:
        return None
    return readers.share_percent(
        readers.flash_bound_s(reading, counts.flash_backward_work),
        reading.trace.seconds(PATTERNS))

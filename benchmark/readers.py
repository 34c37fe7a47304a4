"""What the per-layer readers in ``metrics/`` share. Each returns None
when the reading holds nothing for it, never 0 for a share of a peak or
a roofline."""

from __future__ import annotations

from benchmark import counts
from benchmark.peaks import PEAK_FLOPS


def idle_percent(reading):
    """The share of the traced sub-window with nothing running on the
    device, in percent."""
    trace = getattr(reading, "trace", None)
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def share_percent(bound_s: float, seconds: float):
    """A roofline share: the least time over the time taken."""
    if bound_s <= 0 or seconds <= 0:
        return None
    return 100.0 * bound_s / seconds


def mfu_percent(flops: float, seconds: float):
    if flops <= 0 or not seconds or seconds <= 0:
        return None
    return 100.0 * flops / seconds / PEAK_FLOPS


def flash_bound_s(reading, work) -> float:
    """The traced steps' least attention time: every layer's launch at
    each traced batch's live pairs, by ``work`` (a ``counts`` function
    of (config, batch, seq, pairs))."""
    c = reading.counts
    cfg = c["config"]
    return sum(cfg["layers"] * counts.bound_seconds(
        *work(cfg, c["batch"], c["seq"], pairs))
        for pairs in c["traced_pairs"])

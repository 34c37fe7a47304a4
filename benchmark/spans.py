"""The traced steps' time split by the program's own spans.

Both train steps of the program run under ``record_function`` ranges:
``train.step`` around each step, and ``train.forward``,
``train.backward`` and ``train.optimizer`` inside it. They land on the
trace's host timeline, whose clock is the device operations' clock.
Every second of the traced window goes to one of the three, or to none:

- a device operation to the span in which the host enqueued it. The
  steps run on one stream, so the k-th device operation of the window
  is the k-th enqueue call on the host (:data:`ENQUEUE`);
- an idle gap to the span the host was in at the gap's middle: the
  queue is empty then, so the host's position is what holds the card
  back.

The window opens and closes on a device sync, so the two counts are
equal; where they differ the pairing is unknown and nothing is read.
Only ``reading.trace`` (``kernels`` and ``host``) is read.
"""

from __future__ import annotations

import bisect

STEP = "train.step"
SPANS = ("train.forward", "train.backward", "train.optimizer")
# The host calls that put one operation on a stream, as CUPTI names them
# in a trace of the two train steps on an H100 (runtime and driver API).
ENQUEUE = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
})


def split_ms(trace) -> dict | None:
    """Milliseconds a step of each of :data:`SPANS` (the steps counted
    as the :data:`STEP` ranges in the window), or None without a step
    or where enqueue calls and device operations do not pair."""
    if trace is None:
        return None
    steps = sum(1 for name, _, _ in trace.host if name == STEP)
    if not steps:
        return None
    enqueues = sorted(start for name, start, _ in trace.host
                      if name in ENQUEUE)
    ops = sorted(trace.kernels, key=lambda k: k[1])
    if len(enqueues) != len(ops):
        return None
    spans = sorted((start, end, name) for name, start, end in trace.host
                   if name in SPANS)
    starts = [start for start, _, _ in spans]

    def owner(t: float):
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and spans[i][1] >= t else None

    seconds = dict.fromkeys(SPANS, 0.0)
    for t, (_, a, b) in zip(enqueues, ops):
        name = owner(t)
        if name is not None:
            seconds[name] += b - a
    for a, b in trace.idle_gaps():
        name = owner((a + b) / 2)
        if name is not None:
            seconds[name] += b - a
    return {name: 1000.0 * s / steps for name, s in seconds.items()}


def span_ms(reading, name: str):
    """``name``'s milliseconds a step in the reading's trace, or None."""
    split = split_ms(getattr(reading, "trace", None))
    return None if split is None else split[name]

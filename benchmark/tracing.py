"""The device trace of a steady sub-window of a traced run.

``torch.profiler`` (CUPTI) records every device operation and the
host's operations and CUDA runtime calls; events stay in memory and no
trace file is written. The sub-window is delimited by two host marks,
each just after a device synchronisation, so the device operations
inside it are exactly those of the work between them.

From the events: ``busy_s`` (the union of the intervals in which a
device operation ran), ``window_s``, each kernel's time by name, and
the idle gaps, each labelled by what the host was doing at its middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict

START = "benchmark.window.start"
END = "benchmark.window.end"
TOP = 10
# Host events looked at, back from a gap, for the one that covers it.
SCAN = 4096


def _ns(event, which: str) -> int:
    return int(getattr(event, f"{which}_ns")())


def short_name(name: str) -> str:
    """A kernel's name without a leading ``void``, anonymous namespaces
    and its argument list (the first parenthesis outside its template
    arguments), at most 120 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name.strip()[:120]


@dataclasses.dataclass
class Trace:
    """``kernels``: (name, start s, end s) of every device operation,
    clipped to the window and timed from its start; ``host``: (name,
    start s, end s) of the host's operations and runtime calls."""

    window_s: float
    kernels: list
    host: list
    _starts: list | None = dataclasses.field(default=None, repr=False)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in _union(self.kernels))

    def seconds(self, patterns) -> float:
        """Device seconds of the operations whose name contains any of
        ``patterns``."""
        return sum(end - start for name, start, end in self.kernels
                   if any(p in name for p in patterns))

    def idle_gaps(self) -> list[tuple[float, float]]:
        gaps, at = [], 0.0
        for a, b in _union(self.kernels):
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if at < self.window_s:
            gaps.append((at, self.window_s))
        return gaps

    def host_label(self, t: float) -> str:
        """The innermost host operation running at ``t``: of those that
        cover it, the one that started last (host events nest)."""
        if self._starts is None:
            self.host.sort(key=lambda h: h[1])
            self._starts = [h[1] for h in self.host]
        i = bisect.bisect_right(self._starts, t)
        for name, _, end in reversed(self.host[max(0, i - SCAN):i]):
            if end >= t:
                return name
        return "host between operations"

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time
        by what the host was doing, each at most :data:`TOP` entries."""
        ops: dict = defaultdict(float)
        for name, start, end in self.kernels:
            ops[short_name(name)] += end - start
        idle: dict = defaultdict(float)
        for a, b in self.idle_gaps():
            idle[self.host_label((a + b) / 2)] += b - a

        def top(table):
            return [[k, v] for k, v in sorted(table.items(),
                                              key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def _union(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for _, a, b in sorted(intervals, key=lambda k: k[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_events(events) -> Trace:
    """A :class:`Trace` from kineto events: the window between the
    :data:`START` and :data:`END` marks."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    marks = {}
    device, host = [], []
    for e in events:
        name = e.name()
        if name in (START, END):
            if e.device_type() != cuda:
                marks[name] = _ns(e, "start")
            continue
        annotation = getattr(e, "is_user_annotation", None)
        if e.device_type() == cuda:
            if annotation is not None and annotation():
                continue
            if not name:
                kind = getattr(e, "activity_type", None)
                name = f"({kind() if kind else 'unnamed'})"
            device.append((name, _ns(e, "start"), _ns(e, "end")))
        else:
            host.append((name, _ns(e, "start"), _ns(e, "end")))
    t0, t1 = marks[START], marks[END]

    def clip(items):
        out = []
        for name, a, b in items:
            a, b = max(a, t0), min(b, t1)
            if b > a:
                out.append((name, (a - t0) / 1e9, (b - t0) / 1e9))
        return out

    return Trace(window_s=(t1 - t0) / 1e9, kernels=clip(device),
                 host=clip(host))


class Window:
    """``with Window(sync) as w:`` profiles the work inside; ``w.trace``
    is its :class:`Trace`, reduced from the events when first read (so
    after the run's own window, not inside it). ``sync`` waits for the
    device (every card this process drives)."""

    def __init__(self, sync):
        self.sync = sync
        self._trace: Trace | None = None
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self.sync()
        with record_function(START):
            pass
        return self

    def __exit__(self, *exc):
        from torch.profiler import record_function

        try:
            self.sync()
            with record_function(END):
                pass
        finally:
            self._prof.stop()
        return False

    @property
    def trace(self) -> Trace:
        if self._trace is None:
            self._trace = reduce_events(
                self._prof.profiler.kineto_results.events())
            self._prof = None
        return self._trace


"""Phase-level profiling for the serving engine's cycle, the train
loop and the train steps.

A trimmed copy of ``kubeflow_tpu/obs/profile.py`` as far as the engine,
the checkpointed loop and step telemetry use it: :class:`PhaseProfiler`
(rolling per-phase percentile digests, a per-cycle activation scope),
:func:`active_digest` and the device-memory watermark, which here reads
``torch.cuda.memory_stats`` and is None on the CPU.

:func:`span` is the one span primitive: :meth:`PhaseProfiler.phase` and
the train steps' ``train.step`` / ``train.forward`` / ``train.backward``
/ ``train.optimizer`` ranges go through it. While a ``torch.profiler``
records, a span is a ``record_function`` range on the trace's host
timeline, whose clock is the device operations' clock; under a
:class:`PhaseProfiler` its host seconds land in that profiler's digest.
With neither, it costs one flag read and one context-variable read.

Environment: ``KFT_PROFILE_WINDOW`` (digest window, default 512) and
``KFT_PROFILE_MEMORY`` (anything but "1"/"true"/"yes" disables the
watermark), parsed as the reference parses them (``obs/envknob.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from collections import deque
from typing import Callable

from torch.autograd import profiler as _torch_profiler

from kubeflow_tpu_torch.obs.envknob import env_bool, env_number

_ACTIVE: contextvars.ContextVar["PhaseProfiler | None"] = \
    contextvars.ContextVar("kubeflow_tpu_torch_active_profiler", default=None)
_SCOPE: contextvars.ContextVar[dict | None] = \
    contextvars.ContextVar("kubeflow_tpu_torch_profile_scope", default=None)


class PhaseDigest:
    """Rolling-window duration digest for one named phase: the last
    ``window`` observations plus cumulative count/total/max, with exact
    nearest-rank percentiles over the window. Serialized by the owning
    profiler."""

    __slots__ = ("_window", "count", "total_s", "max_s", "last_s")

    def __init__(self, window: int = 512):
        self._window: deque = deque(maxlen=max(1, int(window)))
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.last_s = 0.0

    def observe(self, seconds: float) -> None:
        seconds = max(float(seconds), 0.0)
        self._window.append(seconds)
        self.count += 1
        self.total_s += seconds
        self.last_s = seconds
        self.max_s = max(self.max_s, seconds)

    def percentile(self, q: float) -> float:
        if not self._window:
            return 0.0
        values = sorted(self._window)
        q = min(max(float(q), 0.0), 1.0)
        rank = int(q * len(values))
        if rank < q * len(values):
            rank += 1
        rank = min(max(rank, 1), len(values))
        return values[rank - 1]

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "window": len(self._window),
            "total_s": round(self.total_s, 6),
            "last_s": round(self.last_s, 6),
            "max_s": round(self.max_s, 6),
            "p50_s": round(self.percentile(0.50), 6),
            "p90_s": round(self.percentile(0.90), 6),
            "p99_s": round(self.percentile(0.99), 6),
        }


class PhaseProfiler:
    """Per-phase wall-time attribution with rolling percentile digests.
    Thread-safe: the scheduler thread writes, handler threads read."""

    def __init__(self, window: int | None = None,
                 clock: Callable[[], float] = time.perf_counter,
                 memory: bool | None = None):
        self.window = (window if window is not None
                       else env_number("KFT_PROFILE_WINDOW", 512, cast=int))
        self._clock = clock
        self.memory = (env_bool("KFT_PROFILE_MEMORY", True)
                       if memory is None else bool(memory))
        self._lock = threading.Lock()
        self._digests: dict[str, PhaseDigest] = {}

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            digest = self._digests.get(name)
            if digest is None:
                digest = self._digests[name] = PhaseDigest(self.window)
            digest.observe(seconds)
        if _ACTIVE.get() is self:
            scope = _SCOPE.get()
            if scope is not None:
                scope[name] = scope.get(name, 0.0) + max(float(seconds), 0.0)

    def phase(self, name: str):
        """``with profiler.phase(name):`` observes the block's host
        seconds under ``name`` (a :func:`span` into this profiler)."""
        return span(name, self)

    @contextlib.contextmanager
    def activate(self):
        """Install this profiler as the active one and open a per-cycle
        scope; yields the scope dict (phase -> seconds this cycle)."""
        scope: dict[str, float] = {}
        token = _ACTIVE.set(self)
        scope_token = _SCOPE.set(scope)
        try:
            yield scope
        finally:
            _SCOPE.reset(scope_token)
            _ACTIVE.reset(token)

    def snapshot(self) -> dict:
        with self._lock:
            return {name: digest.snapshot()
                    for name, digest in sorted(self._digests.items())}

    def compact(self) -> dict:
        with self._lock:
            return {name: {"p50_s": round(d.percentile(0.50), 6),
                           "p99_s": round(d.percentile(0.99), 6),
                           "n": d.count}
                    for name, d in sorted(self._digests.items())}

    def watermark(self) -> dict | None:
        return memory_watermark() if self.memory else None


class _Span:
    """An open :func:`span`: a ``record_function`` range while a
    ``torch.profiler`` records, host seconds into ``profiler``."""

    __slots__ = ("_name", "_profiler", "_range", "_t0")

    def __init__(self, name: str, profiler: "PhaseProfiler | None",
                 recording: bool):
        self._name = name
        self._profiler = profiler
        self._range = (_torch_profiler.record_function(name) if recording
                       else None)
        self._t0 = 0.0

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        if self._profiler is not None:
            self._t0 = self._profiler._clock()
        return self

    def __exit__(self, *exc):
        try:
            if self._profiler is not None:
                self._profiler.observe(self._name,
                                       self._profiler._clock() - self._t0)
        finally:
            if self._range is not None:
                self._range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, profiler: "PhaseProfiler | None" = None):
    """``with span(name):`` around a stretch of host work. While a
    ``torch.profiler`` records, a ``record_function(name)`` range; with
    ``profiler``, or else the :class:`PhaseProfiler` activated on this
    context, the block's host seconds observed under ``name``. With
    neither it is a shared no-op: no allocation, no device call, no
    sync."""
    recording = _torch_profiler._is_profiler_enabled
    if profiler is None:
        profiler = _ACTIVE.get()
    if profiler is None and not recording:
        return _OFF
    return _Span(name, profiler, recording)


def active_digest() -> dict | None:
    """The compact digest of the profiler activated on this context (the
    phases a :class:`~kubeflow_tpu_torch.obs.telemetry.StepTelemetry`
    record carries), or None outside an activation or before any phase
    landed."""
    prof = _ACTIVE.get()
    if prof is None:
        return None
    return prof.compact() or None


def memory_watermark() -> dict | None:
    """Allocator usage on the current CUDA device, or None without one:
    ``{"devices", "bytes_in_use", "peak_bytes_in_use", "bytes_limit"}``."""
    import torch

    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats()
    _, total = torch.cuda.mem_get_info()
    return {
        "devices": 1,
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }

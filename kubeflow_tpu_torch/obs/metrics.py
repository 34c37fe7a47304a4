"""Metric primitives and the platform-wide label schema.

A trimmed copy of ``kubeflow_tpu/obs/metrics.py``: the label vocabulary,
the default bucket bounds and :class:`BucketHistogram`, a thread-safe
cumulative-bucket histogram whose snapshot is shaped for Prometheus
exposition (``obs/exposition.py`` renders it), with OpenMetrics
exemplars on request. The quantile reader, which no caller of the port
has, is left out.
"""

from __future__ import annotations

import threading
import time

# The only label names any collector may use (the reference's schema, so
# dashboards join the port's series with the platform's). "le" and
# "quantile" are the exposition format's own.
CANONICAL_LABELS = frozenset({
    "namespace", "name", "controller",
    "accelerator", "verb", "kind", "result", "mode", "severity",
    "method", "endpoint", "code", "outcome", "phase", "actuator",
    "le", "quantile",
})

LATENCY_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
REQUEST_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


class BucketHistogram:
    """Cumulative-bucket histogram: observe / snapshot.

    With ``exemplars=True`` each bucket also keeps the latest observation
    that landed in it with its trace id (given, or the current sampled
    span's): the OpenMetrics exemplar that links a slow bucket to the
    trace behind it. Unsampled spans are never recorded."""

    def __init__(self, buckets: tuple[float, ...] = LATENCY_BUCKETS,
                 exemplars: bool = False):
        self._bounds = tuple(sorted(float(b) for b in buckets))
        if not self._bounds:
            raise ValueError("at least one bucket bound required")
        self._counts = [0] * (len(self._bounds) + 1)  # +1 = overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        self._exemplars_enabled = bool(exemplars)
        # bucket index -> (trace_id, observed value, unix timestamp)
        self._exemplars: dict[int, tuple[str, float, float]] = {}

    def observe(self, value: float, trace_id: str | None = None) -> None:
        value = float(value)
        idx = len(self._bounds)
        for i, bound in enumerate(self._bounds):
            if value <= bound:
                idx = i
                break
        if self._exemplars_enabled and trace_id is None:
            from kubeflow_tpu_torch.obs.trace import current_span

            span = current_span()
            if span is not None and span.context.sampled:
                trace_id = span.context.trace_id
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if self._exemplars_enabled and trace_id:
                self._exemplars[idx] = (trace_id, value, time.time())

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> dict:
        """{"count", "sum", "buckets": [("0.005", cum), ..., ("+Inf", n)]}
        plus, with exemplars on, ``"exemplars"``: bucket bound string ->
        {"trace_id", "value", "ts"}."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
            acc_sum = self._sum
            exemplars = (dict(self._exemplars) if self._exemplars_enabled
                         else None)
        buckets: list[tuple[str, int]] = []
        cumulative = 0
        for bound, count in zip(self._bounds, counts):
            cumulative += count
            buckets.append((repr(bound), cumulative))
        buckets.append(("+Inf", total))
        snap = {"count": total, "sum": acc_sum, "buckets": buckets}
        if exemplars is not None:
            labels = [repr(b) for b in self._bounds] + ["+Inf"]
            snap["exemplars"] = {
                labels[idx]: {"trace_id": tid, "value": val, "ts": ts}
                for idx, (tid, val, ts) in sorted(exemplars.items())}
        return snap

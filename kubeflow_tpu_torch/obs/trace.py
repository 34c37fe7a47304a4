"""Spans and W3C trace-context propagation (stdlib only).

A trimmed copy of ``kubeflow_tpu/obs/trace.py`` as far as the port's
gateway uses it: :class:`SpanContext`, the
``traceparent`` header (:func:`parse_traceparent`,
:func:`format_traceparent`), :class:`Span`, :class:`Tracer` (root
sampling, the current span on a ``contextvars.ContextVar``) and the
process-wide :func:`get_tracer`.

Each gateway request runs in a span parented on its incoming
``traceparent``, so the request's latency lands in the trace of whatever
created it upstream; a sampled span's trace id rides the latency
histograms as an exemplar and the structured log lines as ``trace_id``.
Finished spans are exported nowhere: the reference's span ring (the
``/debug/traces`` source), its JSONL exporter and the CR annotation that
carries a trace across the controller's watch are left out, as the port
has no route or caller that reads them.

Environment: ``OBS_TRACE_SAMPLE`` (root sample rate, default 1.0).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import re
import threading

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})"
    r"(?:-[^\s]*)?$"
)

_CURRENT: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "kubeflow_tpu_torch_obs_current_span", default=None
)


class SpanContext:
    """The propagated identity of a span: (trace id, span id, sampled).

    Immutable; ``sampled`` rides the traceparent flags byte (bit 0) so
    a sampling decision made at the edge holds across every process the
    trace visits."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def __repr__(self):
        return (f"SpanContext(trace_id={self.trace_id!r}, "
                f"span_id={self.span_id!r}, sampled={self.sampled})")


def parse_traceparent(header: str | None) -> SpanContext | None:
    """W3C traceparent → SpanContext, or None for anything malformed.

    Per the spec: exactly-sized lowercase hex fields, version ``ff``
    invalid, all-zero trace or span id invalid. Trailing fields from
    future versions are tolerated; a malformed header NEVER raises —
    the caller just starts a fresh trace."""
    if not header or not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff":
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    try:
        sampled = bool(int(flags, 16) & 0x01)
    except ValueError:  # unreachable given the regex, but never raise
        return None
    return SpanContext(trace_id, span_id, sampled)


def format_traceparent(ctx: SpanContext) -> str:
    return (f"00-{ctx.trace_id}-{ctx.span_id}-"
            f"{'01' if ctx.sampled else '00'}")


def current_span() -> "Span | None":
    """The span active on this thread/context, or None."""
    return _CURRENT.get()


class Span:
    """One named interval's identity: its :class:`SpanContext`, its
    parent's span id and its attributes (the goodput meter labels a
    downtime span with its kind). The reference's events, status and
    times feed its exporters; the port exports nothing, so it keeps none
    of them."""

    __slots__ = ("name", "context", "parent_id", "attributes")

    def __init__(self, name: str, context: SpanContext,
                 parent_id: str | None):
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.attributes: dict = {}

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value


# Distinguishes "no parent passed: inherit the current span" from an
# explicit parent=None ("start a new root trace").
_INHERIT = object()


class Tracer:
    """Span factory + context manager + sampling.

    Head-based sampling: the decision is drawn once at the root
    (``OBS_TRACE_SAMPLE``) and inherited by children and remote
    continuations via the traceparent flags, so a trace is always
    complete-or-absent, never ragged."""

    def __init__(
        self,
        sample_rate: float | None = None,
        rng: random.Random | None = None,
    ):
        if sample_rate is None:
            try:
                sample_rate = float(os.environ.get("OBS_TRACE_SAMPLE", "1"))
            except ValueError:
                sample_rate = 1.0
        self.sample_rate = min(max(sample_rate, 0.0), 1.0)
        # Seedable for deterministic sampling tests; lock-protected —
        # random.Random is not thread-safe and spans start on watch,
        # server and worker threads concurrently.
        self._rng = rng or random.Random()
        self._lock = threading.Lock()

    # ---- ids -------------------------------------------------------------
    @staticmethod
    def _new_trace_id() -> str:
        return os.urandom(16).hex()

    @staticmethod
    def _new_span_id() -> str:
        return os.urandom(8).hex()

    def _sampled(self) -> bool:
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < self.sample_rate

    # ---- span lifecycle --------------------------------------------------
    def start_span(
        self,
        name: str,
        parent: "SpanContext | Span | None" = _INHERIT,
    ) -> Span:
        """Start (but do not activate) a span. ``parent`` defaults to
        the current span; pass an explicit SpanContext (remote parent)
        or None (force a new root)."""
        if parent is _INHERIT:
            cur = _CURRENT.get()
            parent = cur.context if cur is not None else None
        elif isinstance(parent, Span):
            parent = parent.context
        if parent is None:
            ctx = SpanContext(
                self._new_trace_id(), self._new_span_id(), self._sampled()
            )
            return Span(name, ctx, None)
        ctx = SpanContext(parent.trace_id, self._new_span_id(), parent.sampled)
        return Span(name, ctx, parent.span_id)

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        parent: "SpanContext | Span | None" = _INHERIT,
    ):
        """``with tracer.span("request") as sp:`` — activates the span
        on the current context for the block."""
        sp = self.start_span(name, parent=parent)
        token = _CURRENT.set(sp)
        try:
            yield sp
        finally:
            _CURRENT.reset(token)


_tracer: Tracer | None = None
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-wide tracer, created at first use from the OBS_*
    environment; every instrumentation point calls this, so
    :func:`set_tracer` re-routes the whole process."""
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer


def set_tracer(tracer: Tracer | None) -> None:
    """Replace (or with ``None`` reset) the process-wide tracer: tests
    install a private one and restore after."""
    global _tracer
    with _tracer_lock:
        _tracer = tracer

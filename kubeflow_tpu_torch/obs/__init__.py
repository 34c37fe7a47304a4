"""Port-local observability: trimmed copies of the reference's
``kubeflow_tpu/obs`` as far as the serving engine, the gateway, the pod
entrypoint and the autopilot use them (the port imports nothing of the
JAX package): metric primitives and the label schema, the profiler and
flight recorder, spans and ``traceparent``, structured logging, SLOs
with burn-rate alerts, and a Prometheus/OpenMetrics exposition that
needs no ``prometheus_client``."""

from kubeflow_tpu_torch.obs.alerts import SloEngine
from kubeflow_tpu_torch.obs.logging import (
    JsonLogFormatter,
    configure_structured_logging,
)
from kubeflow_tpu_torch.obs.metrics import CANONICAL_LABELS, BucketHistogram
from kubeflow_tpu_torch.obs.profile import PhaseProfiler, memory_watermark
from kubeflow_tpu_torch.obs.recorder import FlightRecorder
from kubeflow_tpu_torch.obs.slo import BurnRateEvaluator, Objective
from kubeflow_tpu_torch.obs.trace import (
    Span,
    SpanContext,
    Tracer,
    current_span,
    format_traceparent,
    get_tracer,
    parse_traceparent,
    set_tracer,
)

__all__ = ["BucketHistogram", "BurnRateEvaluator", "CANONICAL_LABELS",
           "FlightRecorder", "JsonLogFormatter", "Objective",
           "PhaseProfiler", "SloEngine", "Span", "SpanContext", "Tracer",
           "configure_structured_logging", "current_span",
           "format_traceparent", "get_tracer", "memory_watermark",
           "parse_traceparent", "set_tracer"]

"""Inference serving on the card: the streaming engine over the
continuous batcher (bounded inbox, capped prefill-per-cycle
interleaving, prefix-cache reuse, chunked prefill, hot swap,
speculative n-gram decoding), the serialized ``generate()`` fallback for
MoE models, their
scheduler thread, the HTTP/SSE gateway (``gateway.py``) and the pod
entrypoint ``python -m kubeflow_tpu_torch.serving`` (``__main__.py``)."""

from kubeflow_tpu_torch.serving.engine import (
    GenerateFallbackEngine,
    PrefixCache,
    QueueFull,
    Scheduler,
    StreamingBatcher,
    make_engine,
)
from kubeflow_tpu_torch.serving.gateway import InferenceGateway

__all__ = [
    "GenerateFallbackEngine",
    "InferenceGateway",
    "PrefixCache",
    "QueueFull",
    "Scheduler",
    "StreamingBatcher",
    "make_engine",
]

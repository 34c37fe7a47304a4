"""Structured JSON logging, trace-correlated (stdlib only).

A copy of ``kubeflow_tpu/obs/logging.py`` for the port's pod entrypoint.
Every record becomes one JSON object with a fixed schema:

    {"ts": <RFC3339 UTC>, "level": "WARNING",
     "logger": "kubeflow_tpu_torch.x", "msg": "...", "trace_id": "...",
     "span_id": "..."}

``trace_id``/``span_id`` appear whenever a span is active on the
emitting thread. Caller-supplied ``extra=`` fields ride along verbatim;
unserializable values degrade to ``repr`` rather than crash the logging
path.
"""

from __future__ import annotations

import json
import logging
import time
import traceback

# Keys every structured record carries (the obs gate's schema check).
SCHEMA_KEYS = ("ts", "level", "logger", "msg")

# logging.LogRecord's own attributes: everything else on the record is
# a caller-supplied extra= field and is forwarded into the JSON object.
_RESERVED = frozenset(vars(
    logging.LogRecord("", 0, "", 0, "", (), None)
)) | {"message", "asctime", "taskName"}


class JsonLogFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        doc: dict = {
            "ts": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime(record.created)
            ),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        from kubeflow_tpu_torch.obs.trace import current_span

        span = current_span()
        if span is not None:
            doc["trace_id"] = span.context.trace_id
            doc["span_id"] = span.context.span_id
        for key, value in record.__dict__.items():
            if key not in _RESERVED and key not in doc:
                doc[key] = value
        if record.exc_info and record.exc_info[0] is not None:
            doc["exc"] = "".join(
                traceback.format_exception(*record.exc_info)
            ).rstrip()
        try:
            return json.dumps(doc, default=repr)
        except (TypeError, ValueError):
            # A pathological extra (e.g. a key that is not a string)
            # must not lose the message: fall back to the schema core.
            return json.dumps({k: doc[k] for k in SCHEMA_KEYS})


_CONFIGURED_MARK = "_kubeflow_tpu_torch_obs_handler"


def configure_structured_logging(
    level: int = logging.INFO,
    stream=None,
    logger_name: str = "kubeflow_tpu_torch",
) -> logging.Handler:
    """Attach a JSON handler to the port's logger tree. Idempotent:
    a second call re-uses the existing handler (entrypoints and tests
    both call it). Returns the handler so callers can retarget or
    detach it."""
    logger = logging.getLogger(logger_name)
    for handler in logger.handlers:
        if getattr(handler, _CONFIGURED_MARK, False):
            handler.setLevel(level)
            logger.setLevel(level)
            return handler
    handler = logging.StreamHandler(stream)
    handler.setFormatter(JsonLogFormatter())
    handler.setLevel(level)
    setattr(handler, _CONFIGURED_MARK, True)
    logger.addHandler(handler)
    logger.setLevel(level)
    # The platform logger owns its records now: without this, the root
    # logger's (basicConfig) handler would print every record a second
    # time, unstructured.
    logger.propagate = False
    return handler

"""HTTP gateway: SSE token streaming over the port's serving engine.

The counterpart of ``kubeflow_tpu/serving/gateway.py``, with the same
HTTP surface (stdlib ``http.server`` threads):

- ``POST /v1/generate`` — body ``{"prompt": [ints],
  "max_new_tokens": n, "temperature": t, "seed": s, "stream": bool}``.
  With ``stream`` (the default) the response is ``text/event-stream``:
  one ``data: {"token": t, "index": i}`` frame per token as the
  scheduler produces it, then a terminal ``event: done`` frame carrying
  the full token list, finish reason and prefix-cache verdict.
  ``stream: false`` returns one JSON object after the last token.
  ``seed`` is required iff ``temperature > 0`` (the server never
  invents entropy); it seeds the request's ``torch.Generator``, so a
  sampled stream equals the port's ``generate(..., rng=seed)``, not the
  reference's ``jax.random`` stream.
- **Admission control**: on :class:`~kubeflow_tpu_torch.serving.engine.
  QueueFull` the gateway sheds with ``429`` + ``Retry-After``.
- ``POST /v1/admin/swap`` — runs the configured ``reload_fn`` and stages
  the returned params on the engine (404 without one, 409 when it finds
  nothing to load).
- ``GET /healthz``, ``/readyz`` (fails when the scheduler is wedged),
  ``/v1/status``, and ``/debug/profile`` and ``/debug/flightrecord``
  behind ``KFT_ENABLE_DEBUG_ENDPOINTS``.
- ``GET /metrics`` — the reference's metric names, help strings, labels
  (all in ``CANONICAL_LABELS``) and bounds: Prometheus text 0.0.4, or
  OpenMetrics (with TTFT/ITL exemplars) when the scraper asks for it.
  Rendered by ``obs/exposition.py``: the port needs no
  ``prometheus_client``.
- Every request runs in a span parented on an incoming ``traceparent``;
  its trace id rides the TTFT/ITL observations as an exemplar.

A client that hangs up mid-stream is recorded as the outcome
``disconnect``; its slot runs to the end of its budget (the engine has
no cancel path, as in the reference).
"""

from __future__ import annotations

import http.server
import json
import logging
import queue
import threading
import time
import urllib.parse

from kubeflow_tpu_torch.obs import slo as obs_slo
from kubeflow_tpu_torch.obs.alerts import SloEngine
from kubeflow_tpu_torch.obs.envknob import env_bool
from kubeflow_tpu_torch.obs.exposition import (
    CONTENT_TYPE_OPENMETRICS,
    CONTENT_TYPE_TEXT,
    Counter,
    CounterFamily,
    Gauge,
    GaugeFamily,
    Histogram,
    HistogramFamily,
    Registry,
    render_openmetrics,
    render_text,
)
from kubeflow_tpu_torch.obs.metrics import LATENCY_BUCKETS, REQUEST_BUCKETS
from kubeflow_tpu_torch.obs.trace import get_tracer, parse_traceparent
from kubeflow_tpu_torch.serving.engine import QueueFull, Scheduler

log = logging.getLogger(__name__)


class EngineCollector:
    """Engine-side counters and histograms rendered at scrape time (the
    engine keeps plain ``BucketHistogram``s and counters)."""

    def __init__(self, engine):
        self.engine = engine

    def describe(self):
        return []

    def collect(self):
        cache = getattr(self.engine, "prefix_cache", None)
        fam = CounterFamily(
            "inference_prefix_cache",
            "Prefill prefix-cache lookups by outcome",
            labels=["outcome"],
        )
        fam.add_metric(["hit"], cache.hits if cache is not None else 0)
        fam.add_metric(["miss"], cache.misses if cache is not None else 0)
        yield fam
        yield CounterFamily(
            "inference_model_swap",
            "Hot model swaps applied by the scheduler",
            value=getattr(self.engine, "swaps_total", 0),
        )
        fam = HistogramFamily(
            "inference_batch_cycle_seconds",
            "Scheduler cycle wall time by phase (admit = inbox drain, "
            "prefill = admissions this cycle, decode = one step_chunk "
            "dispatch + trim, verify/commit = speculative sub-steps)",
            labels=["phase"],
        )
        for phase, hist in sorted(self.engine.cycle_seconds.items()):
            snap = hist.snapshot()
            fam.add_metric([phase], buckets=snap["buckets"],
                           sum_value=snap["sum"])
        yield fam
        # Batch occupancy: how full the decode batch ran after the
        # last cycle — the denominator pair for "is the fleet
        # under-batched or queue-bound" next to inference_queue_depth.
        fam = GaugeFamily(
            "inference_slots_active",
            "Decode slots occupied after the most recent scheduler "
            "cycle",
        )
        fam.add_metric([], getattr(self.engine, "occupancy", 0))
        yield fam
        fam = GaugeFamily(
            "inference_slots_total",
            "Decode slots this engine batches over (1 for the "
            "serialized fallback)",
        )
        fam.add_metric([], getattr(self.engine, "slots_total", 0))
        yield fam


class GatewayMetrics:
    """The gateway-side registry (request-path metrics) + the engine
    collector. Labels stay inside ``obs.CANONICAL_LABELS``."""

    def __init__(self, engine):
        self.registry = Registry()
        self.registry.register(EngineCollector(engine))
        self.request_duration = Histogram(
            "inference_request_duration_seconds",
            "Wall time of one /v1/generate request, arrival to last "
            "byte (outcome: ok, shed, bad_request, error, timeout, "
            "disconnect)",
            ["outcome"],
            registry=self.registry,
            buckets=LATENCY_BUCKETS,
        )
        self.ttft = Histogram(
            "inference_ttft_seconds",
            "Time from request arrival to the first streamed token",
            registry=self.registry,
            buckets=LATENCY_BUCKETS,
        )
        # Inter-token gaps, observed per token after the first: the
        # steady-state decode SLI (the QPS harness derives its
        # itl_p50/p99 from per-request timelines; this is the live
        # gateway-side view of the same distribution). Request-bucket
        # spread: gaps live in the milliseconds, not minutes.
        self.itl = Histogram(
            "inference_itl_seconds",
            "Gap between consecutive streamed tokens of one request "
            "(inter-token latency)",
            registry=self.registry,
            buckets=REQUEST_BUCKETS,
        )
        self.tokens_total = Counter(
            "inference_tokens",
            "Tokens through the gateway (kind: prompt = received, "
            "generated = streamed out)",
            ["kind"],
            registry=self.registry,
        )
        self.shed_total = Counter(
            "inference_shed",
            "Requests shed with 429 because the admission queue was "
            "full",
            registry=self.registry,
        )
        self.queue_depth = Gauge(
            "inference_queue_depth",
            "Requests admitted by the gateway but not yet scheduled "
            "onto compute",
            registry=self.registry,
        )
        self.queue_depth.set_function(engine.pending)

    def exposition(self, openmetrics: bool = False) -> bytes:
        # OpenMetrics carries the TTFT exemplars (trace-id links);
        # classic 0.0.4 text stays the default for existing scrapers.
        if openmetrics:
            return render_openmetrics(self.registry)
        return render_text(self.registry)


def make_gateway_slo_engine(metrics: GatewayMetrics, clock=None,
                            recorder=None):
    """Serving SLO set (obs.slo defaults; KFT_SLO_* env tunes):
    first-token latency and inter-token latency over the gateway's own
    histograms. With a ``recorder`` (the engine's FlightRecorder), any
    alert going firing dumps the cycle-snapshot ring — the black-box
    window leading up to the burn."""
    kwargs = {"clock": clock} if clock is not None else {}
    evaluator = obs_slo.BurnRateEvaluator(**kwargs)
    engine = SloEngine(evaluator=evaluator, recorder=recorder)
    engine.register(obs_slo.ttft_objective(metrics.ttft))
    engine.register(obs_slo.itl_objective(metrics.itl))
    return engine


# Distinguishes "caller said nothing" (build the default engine) from
# an explicit slo=None (disable the SLO layer entirely).
_DEFAULT_SLO = object()


def _trace_exemplar(span) -> dict | None:
    """``observe(exemplar=...)`` payload for the active request span,
    or None when the trace is unsampled (an unsampled id resolves to
    nothing in any exporter)."""
    if span is not None and span.context.sampled:
        return {"trace_id": span.context.trace_id}
    return None


class InferenceGateway:
    """Threaded HTTP server + scheduler thread over one engine.

    ``reload_fn`` (optional) powers ``POST /v1/admin/swap``: a
    zero-arg callable returning ``(params, info_dict)`` — typically a
    closure over ``CheckpointManager.restore_latest_valid``. The
    admin route is unauthenticated and must only be exposed
    pod-locally (the operations doc carries the warning)."""

    def __init__(self, engine, port: int = 0,
                 retry_after_s: float = 1.0,
                 reload_fn=None,
                 stream_timeout_s: float = 120.0,
                 slo=_DEFAULT_SLO,
                 autopilot=None,
                 enable_debug: bool | None = None):
        self.engine = engine
        self.metrics = GatewayMetrics(engine)
        self.scheduler = Scheduler(engine)
        self.reload_fn = reload_fn
        self.retry_after_s = retry_after_s
        self.stream_timeout_s = stream_timeout_s
        # Serving-side SLOs: burn-rate objectives over the gateway's
        # own TTFT/ITL histograms, surfaced in /v1/status and ticked by
        # scrapes/status reads. Injectable for deterministic tests; an
        # explicit None disables the layer. The engine's flight
        # recorder rides along so a TTFT/ITL alert going firing dumps
        # the cycle ring automatically.
        if slo is _DEFAULT_SLO:
            slo = make_gateway_slo_engine(
                self.metrics,
                recorder=getattr(engine, "recorder", None))
        self.slo = slo
        # Actuation: an Autopilot rides the same pending→firing
        # edges that dump the flight recorder — the admission actuator
        # tightens max_pending/prefill_per_cycle while TTFT/ITL burn is
        # critical. Its actions are exposed on /metrics
        # (autopilot_actions_total) and in the /v1/status block.
        self.autopilot = autopilot
        if autopilot is not None:
            from kubeflow_tpu_torch.autopilot import AutopilotCollector

            self.metrics.registry.register(AutopilotCollector(autopilot))
            autopilot.attach(self.slo)
        # /debug/profile + /debug/flightrecord expose live phase
        # digests and the snapshot ring; like the manager's pprof-role
        # endpoints they are strictly opt-in (same env gate).
        if enable_debug is None:
            enable_debug = env_bool("KFT_ENABLE_DEBUG_ENDPOINTS")
        self.enable_debug = bool(enable_debug)
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            # SSE: every token frame must hit the wire now, not after
            # Nagle + delayed-ACK (~40ms/frame — k8s/client.py).
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):
                log.debug("gateway: " + fmt, *args)

            def _json(self, code: int, payload: dict,
                      headers: dict | None = None) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for key, value in (headers or {}).items():
                    self.send_header(key, value)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urllib.parse.urlsplit(self.path).path
                if path == "/healthz":
                    self._json(200, {"status": "ok"})
                elif path == "/readyz":
                    # healthy, not alive: a wedged scheduler (cycles
                    # failing back-to-back) must fail readiness so the
                    # orchestrator restarts the pod.
                    ok = outer.scheduler.healthy
                    self._json(200 if ok else 503,
                               {"ready": bool(ok)})
                elif path == "/metrics":
                    if outer.slo is not None:
                        outer.slo.tick()
                    accept = self.headers.get("Accept", "")
                    om = "application/openmetrics-text" in accept
                    body = outer.metrics.exposition(openmetrics=om)
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        CONTENT_TYPE_OPENMETRICS if om
                        else CONTENT_TYPE_TEXT)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/v1/status":
                    self._json(200, outer.status())
                elif path == "/debug/profile" and outer.enable_debug:
                    # Full per-phase digests (window percentiles, max,
                    # totals) of the engine's scheduler cycles.
                    profiler = getattr(outer.engine, "profiler", None)
                    if profiler is None:
                        self._json(404, {"error": "no profiler"})
                    else:
                        self._json(200, {
                            "engine": profiler.snapshot(),
                            "memory": profiler.watermark(),
                        })
                elif (path == "/debug/flightrecord"
                      and outer.enable_debug):
                    recorder = getattr(outer.engine, "recorder", None)
                    if recorder is None:
                        self._json(404, {"error": "no flight recorder"})
                    else:
                        self._json(200, recorder.to_dict())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                path = urllib.parse.urlsplit(self.path).path
                if path == "/v1/generate":
                    outer._handle_generate(self)
                elif path == "/v1/admin/swap":
                    outer._handle_swap(self)
                else:
                    self._json(404, {"error": "not found"})

        self._server = http.server.ThreadingHTTPServer(("", port),
                                                       Handler)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------ lifecycle
    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def status(self) -> dict:
        doc = {
            "pending": self.engine.pending(),
            "batched": bool(getattr(self.engine, "batched", False)),
            "draining": bool(getattr(self.engine, "draining", False)),
            "swaps": int(getattr(self.engine, "swaps_total", 0)),
            "slots": {
                "active": int(getattr(self.engine, "occupancy", 0)),
                "total": int(getattr(self.engine, "slots_total", 0)),
            },
        }
        # Tick the SLO engine BEFORE snapshotting the flightrecord
        # block: this very read can flip an alert to firing and dump
        # the ring, and the response that triggered the dump must
        # report it (the QPS harness reads /v1/status exactly once).
        if self.slo is not None:
            self.slo.tick()
            doc["slo"] = self.slo.status()
        # Compact cycle-phase digest (admit/prefill/decode/...):
        # p50/p99/n per phase — the block the QPS harness folds into
        # its summary line so bench trajectory sees phase regressions.
        profiler = getattr(self.engine, "profiler", None)
        if profiler is not None:
            doc["profile"] = profiler.compact()
        recorder = getattr(self.engine, "recorder", None)
        if recorder is not None:
            doc["flightrecord"] = {
                "ring": len(recorder),
                "dumps": recorder.dumps_total,
                "last_dump_path": recorder.last_dump_path,
            }
        if self.autopilot is not None:
            doc["autopilot"] = self.autopilot.to_dict()
        return doc

    def start(self) -> "InferenceGateway":
        self.scheduler.start()
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="inference-gateway",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self.scheduler.stop()

    # ------------------------------------------------------ handlers
    def _handle_swap(self, handler) -> None:
        if self.reload_fn is None:
            handler._json(404, {"error": "no reload_fn configured"})
            return
        try:
            params, info = self.reload_fn()
        except Exception as exc:
            log.exception("model reload failed")
            handler._json(500, {"error": f"reload failed: {exc}"})
            return
        if params is None:
            handler._json(409, {"error": "no valid checkpoint to load",
                                "info": info})
            return
        self.engine.swap_params(params)
        handler._json(200, {"staged": True, "info": info})

    def _read_request(self, handler) -> dict | None:
        length = int(handler.headers.get("Content-Length", 0))
        try:
            body = json.loads(handler.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            return None
        return body if isinstance(body, dict) else None

    def _handle_generate(self, handler) -> None:
        started = time.monotonic()
        parent = parse_traceparent(handler.headers.get("traceparent"))
        tracer = get_tracer()
        with tracer.span("inference /v1/generate", parent=parent) as span:
            outcome = self._generate_into(handler, span, started)
        self.metrics.request_duration.labels(outcome).observe(
            time.monotonic() - started)

    def _generate_into(self, handler, span, started: float) -> str:
        """Parse, admit, stream; returns the outcome label. Sends
        exactly one HTTP response on every path."""
        body = self._read_request(handler)
        if body is None:
            handler._json(400, {"error": "body must be a JSON object"})
            return "bad_request"
        prompt = body.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            handler._json(
                400, {"error": "prompt must be a non-empty list of "
                               "token ids"})
            return "bad_request"
        stream = bool(body.get("stream", True))
        try:
            # Scalar coercions are part of request validation: a
            # non-numeric temperature/seed/max_new_tokens must be a
            # JSON 400, not a dropped connection.
            max_new = int(body.get("max_new_tokens", 128))
            temperature = float(body.get("temperature", 0.0))
            rng = None
            if temperature > 0.0:
                seed = body.get("seed")
                if seed is None:
                    handler._json(
                        400, {"error": "temperature > 0 requires a "
                                       "client seed (the server never "
                                       "invents sampling entropy)"})
                    return "bad_request"
                # The request's torch.Generator seed (make_generator).
                rng = int(seed)
        except (TypeError, ValueError) as exc:
            handler._json(400, {"error": f"bad request field: {exc}"})
            return "bad_request"
        events: queue.Queue = queue.Queue()
        try:
            self.engine.submit_stream(
                prompt, events.put, max_new_tokens=max_new,
                temperature=temperature, rng=rng)
        except QueueFull:
            self.metrics.shed_total.inc()
            handler._json(
                429, {"error": "admission queue full; retry later"},
                headers={"Retry-After":
                         str(max(1, int(self.retry_after_s)))})
            return "shed"
        except (TypeError, ValueError) as exc:
            handler._json(400, {"error": str(exc)})
            return "bad_request"
        self.metrics.tokens_total.labels("prompt").inc(len(prompt))
        if stream:
            return self._stream_events(handler, span, events, started)
        return self._collect_events(handler, span, events, started)

    def _next_event(self, events: queue.Queue) -> dict | None:
        try:
            return events.get(timeout=self.stream_timeout_s)
        except queue.Empty:
            return None

    def _stream_events(self, handler, span, events: queue.Queue,
                       started: float) -> str:
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-store")
        handler.end_headers()
        index = 0
        last_token_at: float | None = None
        try:
            while True:
                event = self._next_event(events)
                if event is None:
                    # Engine stalled past the stream timeout: the SSE
                    # headers are gone already, so all we can do is
                    # close the stream without a done frame.
                    return "timeout"
                if "token" in event:
                    now = time.monotonic()
                    if index == 0:
                        self.metrics.ttft.observe(
                            now - started,
                            exemplar=_trace_exemplar(span))
                    else:
                        self.metrics.itl.observe(
                            now - last_token_at,
                            exemplar=_trace_exemplar(span))
                    last_token_at = now
                    frame = json.dumps(
                        {"token": event["token"], "index": index})
                    handler.wfile.write(
                        f"data: {frame}\n\n".encode())
                    handler.wfile.flush()
                    self.metrics.tokens_total.labels("generated").inc()
                    index += 1
                if event.get("done"):
                    payload = json.dumps({
                        "reason": event.get("reason"),
                        "tokens": event.get("tokens", []),
                        "cache_hit": bool(event.get("cache_hit")),
                    })
                    handler.wfile.write(
                        f"event: done\ndata: {payload}\n\n".encode())
                    handler.wfile.flush()
                    return "ok"
        except (BrokenPipeError, ConnectionResetError):
            # Client hung up mid-stream; the engine finishes the slot
            # and the remaining tokens land in a queue nobody reads —
            # bounded by the request budget, then garbage-collected.
            return "disconnect"

    def _collect_events(self, handler, span, events: queue.Queue,
                        started: float) -> str:
        first_at: float | None = None
        last_token_at: float | None = None
        try:
            while True:
                event = self._next_event(events)
                if event is None:
                    handler._json(504,
                                  {"error": "generation timed out"})
                    return "timeout"
                if "token" in event:
                    now = time.monotonic()
                    if first_at is None:
                        first_at = now
                        self.metrics.ttft.observe(
                            first_at - started,
                            exemplar=_trace_exemplar(span))
                    else:
                        self.metrics.itl.observe(
                            now - last_token_at,
                            exemplar=_trace_exemplar(span))
                    last_token_at = now
                if event.get("done"):
                    tokens = event.get("tokens", [])
                    self.metrics.tokens_total.labels("generated").inc(
                        len(tokens))
                    handler._json(200, {
                        "tokens": tokens,
                        "reason": event.get("reason"),
                        "cache_hit": bool(event.get("cache_hit")),
                    })
                    return "ok"
        except (BrokenPipeError, ConnectionResetError):
            # Client closed the socket before the response landed —
            # same accounting as a mid-SSE hangup.
            return "disconnect"

"""The port's HTTP/SSE gateway against the reference gateway, on the CPU.

Both gateways listen on port 0 over their own engines (the reference's
JAX ``StreamingBatcher``, the port's), with the same tiny f32 model: the
port's weights are the reference's, carried across by
``params_from_jax``. The case list mirrors ``tests/test_inference.py``
(``TestGatewayEndToEnd``, ``TestQueueShedding``, ``TestHotSwap``'s
endpoint case and ``TestGatewayMetricsSchema``):

- greedy SSE streams are token-equal across the two gateways and equal
  to ``generate``; the eos reason and ``stream: false`` likewise;
- every 400, 404, 409 and 429 answers with the reference's status and
  body (429 with its ``Retry-After``);
- ``/healthz``, ``/readyz`` and ``/v1/status`` carry the same keys;
- ``/metrics`` has the same family names, types and label names in
  Prometheus text and in OpenMetrics (parsed with ``prometheus_client``'s
  own parsers, which this test may import: the port may not), every
  label within ``CANONICAL_LABELS``;
- a client that drops a stream is counted as ``disconnect`` and the
  next request is served, as in the reference;
- a sampled request gives the same tokens for the same seed, equal to
  the port's ``generate(rng=seed)`` (the port samples from a
  ``torch.Generator``, not ``jax.random``: ROADMAP §C).
"""

from __future__ import annotations

import collections
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import LMConfig as JConfig
from kubeflow_tpu.models import build_lm, create_lm_state
from kubeflow_tpu.models import generate as jgenerate
from kubeflow_tpu.serving.engine import StreamingBatcher as JEngine
from kubeflow_tpu.serving.gateway import InferenceGateway as JGateway
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.decoding import generate
from kubeflow_tpu_torch.models.transformer import LMConfig
from kubeflow_tpu_torch.obs.metrics import CANONICAL_LABELS
from kubeflow_tpu_torch.serving import InferenceGateway, StreamingBatcher

SMALL = dict(vocab=128, layers=2, dim=64, heads=4, kv_heads=2)


@pytest.fixture(scope="module")
def lm():
    jcfg = JConfig(dtype=jnp.float32, **SMALL)
    tcfg = LMConfig(dtype=torch.float32, **SMALL)
    model = build_lm(jcfg, use_flash=False)
    jparams = create_lm_state(model, jax.random.key(0), (1, 16)).params
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _engines(lm, **kw):
    jcfg, tcfg, jparams, tparams = lm
    return (JEngine(jcfg, jparams, **kw),
            StreamingBatcher(tcfg, tparams, device="cpu", **kw))


class Pair:
    """The reference gateway and the port's, each over its own engine."""

    def __init__(self, lm, start=True, gateway_kw=None, **engine_kw):
        self.jengine, self.tengine = _engines(lm, **engine_kw)
        kw = gateway_kw or {}
        self.jgw = JGateway(self.jengine, port=0, **kw.get("ref", {}))
        self.tgw = InferenceGateway(self.tengine, port=0,
                                    **kw.get("port", {}))
        self.started = start
        if start:
            self.jgw.start()
            self.tgw.start()
        else:   # only the HTTP listeners: the schedulers stay parked
            for gw in (self.jgw, self.tgw):
                threading.Thread(target=gw._server.serve_forever,
                                 daemon=True).start()

    @property
    def urls(self):
        return (f"http://127.0.0.1:{self.jgw.port}",
                f"http://127.0.0.1:{self.tgw.port}")

    def stop(self):
        for gw in (self.jgw, self.tgw):
            if self.started:
                gw.stop()
            else:
                gw._server.shutdown()
                gw._server.server_close()


def _post(url, path, body, timeout=60, headers=None):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=timeout)


def sse_generate(url, prompt, max_new, extra=None, timeout=120):
    """POST /v1/generate and parse the SSE stream into (tokens, indices,
    done payload, content type)."""
    body = {"prompt": prompt, "max_new_tokens": max_new, **(extra or {})}
    tokens, indices, done = [], [], None
    with _post(url, "/v1/generate", body, timeout) as response:
        ctype = response.headers["Content-Type"]
        event = None
        for raw in response:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                payload = json.loads(line[len("data: "):])
                if event == "done":
                    done = payload
                    break
                tokens.append(payload["token"])
                indices.append(payload["index"])
            elif not line:
                event = None
    return tokens, indices, done, ctype


def _get(url, path, headers=None):
    req = urllib.request.Request(url + path, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers, err.read()


def _families(text, openmetrics):
    from prometheus_client.openmetrics.parser import (
        text_string_to_metric_families as om_parse,
    )
    from prometheus_client.parser import text_string_to_metric_families

    parse = om_parse if openmetrics else text_string_to_metric_families
    out = {}
    for fam in parse(text):
        names = {tuple(sorted(k for k in s.labels if k != "le"))
                 for s in fam.samples}
        labels = {k for s in fam.samples for k in s.labels}
        out[fam.name] = (fam.type, fam.documentation, frozenset(names))
        assert labels <= CANONICAL_LABELS, (fam.name, labels)
    return out


def _metric(url, name, labels=None):
    from prometheus_client.parser import text_string_to_metric_families

    _, _, body = _get(url, "/metrics")
    for fam in text_string_to_metric_families(body.decode()):
        for s in fam.samples:
            if s.name == name and all(s.labels.get(k) == v
                                      for k, v in (labels or {}).items()):
                return s.value
    return None


def _jax_generate(lm, prompt, n):
    jcfg, _, jparams, _ = lm
    out = jgenerate(jcfg, jparams, jnp.asarray([prompt], jnp.int32), n)
    return [int(t) for t in np.asarray(out[0])]


def test_overlapping_greedy_streams_equal_reference_and_generate(lm):
    _, tcfg, _, tparams = lm
    pair = Pair(lm, max_batch=2, max_len=64, prefill_per_cycle=1)
    try:
        rng = np.random.default_rng(11)
        base = [int(t) for t in rng.integers(0, tcfg.vocab, 8)]
        prompts = [base, base + [3, 5],
                   [int(t) for t in rng.integers(0, tcfg.vocab, 6)]]
        results = {}

        def client(side, url, i, prompt):
            results[side, i] = sse_generate(url, prompt, 6)

        threads = [threading.Thread(target=client, args=(side, url, i, p))
                   for i, p in enumerate(prompts)
                   for side, url in enumerate(pair.urls)]
        # ``base`` goes first on both sides and the other two follow once
        # it has a first token (its prefill, and so its prefix-cache
        # entry, is done): whether the extended prompt hits the cache
        # then does not depend on thread scheduling, and the done frames
        # can be compared across the two gateways.
        for t in threads[:2]:
            t.start()
        deadline = time.monotonic() + 120
        while not all(_metric(url, "inference_ttft_seconds_count")
                      for url in pair.urls):
            assert time.monotonic() < deadline
            time.sleep(0.005)
        for t in threads[2:]:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        for i, prompt in enumerate(prompts):
            want = generate(tcfg, tparams, [prompt], 6,
                            device="cpu")[0].tolist()
            assert want == _jax_generate(lm, prompt, 6)
            for side in (0, 1):
                tokens, indices, done, ctype = results[side, i]
                assert ctype == "text/event-stream"
                assert tokens == want, (side, i)
                assert indices == list(range(6))
                assert done == {"reason": "length", "tokens": want,
                                "cache_hit": done["cache_hit"]}
            assert results[0, i][2] == results[1, i][2]
        for url in pair.urls:
            assert _metric(url, "inference_ttft_seconds_count") == 3
            assert _metric(url, "inference_itl_seconds_count") == 15
            assert _metric(url, "inference_prefix_cache_total",
                           {"outcome": "hit"}) >= 1
            assert _metric(url, "inference_tokens_total",
                           {"kind": "generated"}) == 18
            assert _metric(url, "inference_tokens_total",
                           {"kind": "prompt"}) == 24
            assert _metric(url, "inference_request_duration_seconds_count",
                           {"outcome": "ok"}) == 3
            for phase in ("prefill", "decode"):
                assert _metric(url, "inference_batch_cycle_seconds_count",
                               {"phase": phase}) >= 1
    finally:
        pair.stop()


def test_eos_reason_and_nonstream_mode(lm):
    _, tcfg, _, tparams = lm
    prompt = [7, 3, 11, 19, 4]
    ref = generate(tcfg, tparams, [prompt], 8, device="cpu")[0].tolist()
    eos = ref[3]
    cut = ref[:ref.index(eos) + 1]
    pair = Pair(lm, max_batch=2, max_len=64, eos_token=eos)
    try:
        for url in pair.urls:
            tokens, _, done, _ = sse_generate(url, prompt, 8)
            assert tokens == cut and done["reason"] == "eos"
            with _post(url, "/v1/generate", {"prompt": prompt,
                                             "max_new_tokens": 8,
                                             "stream": False}) as r:
                assert r.headers["Content-Type"] == "application/json"
                payload = json.loads(r.read())
            assert payload == {"tokens": cut, "reason": "eos",
                               "cache_hit": True}
    finally:
        pair.stop()


BAD_REQUESTS = {
    "not_json": b"not json",
    "json_list": b"[1, 2]",
    "empty_prompt": {"prompt": []},
    "string_tokens": {"prompt": ["a"]},
    "no_prompt": {"max_new_tokens": 3},
    "temperature_without_seed": {"prompt": [1, 2], "temperature": 0.5},
    "over_capacity": {"prompt": [1] * 220, "max_new_tokens": 60},
    "non_numeric_temperature": {"prompt": [1, 2], "temperature": "hot"},
    "list_max_new_tokens": {"prompt": [1, 2], "max_new_tokens": [5]},
    "non_numeric_seed": {"prompt": [1, 2], "temperature": 0.5,
                         "seed": "x"},
    "zero_budget": {"prompt": [1, 2], "max_new_tokens": 0},
}


@pytest.fixture(scope="module")
def idle_pair(lm):
    pair = Pair(lm, max_batch=1, max_len=64)
    yield pair
    pair.stop()


def _status_and_body(url, method, path, body=None):
    try:
        if method == "POST":
            with _post(url, path, body if body is not None else b"{}") as r:
                return r.status, json.loads(r.read())
        with urllib.request.urlopen(url + path, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_bad_requests_answer_as_the_reference(idle_pair, case):
    body = BAD_REQUESTS[case]
    ref_url, port_url = idle_pair.urls
    want = _status_and_body(ref_url, "POST", "/v1/generate", body)
    got = _status_and_body(port_url, "POST", "/v1/generate", body)
    assert want[0] == 400
    assert got == want


@pytest.mark.parametrize("method,path", [("GET", "/nope"),
                                         ("POST", "/v1/nope"),
                                         ("GET", "/debug/profile"),
                                         ("GET", "/debug/flightrecord"),
                                         ("POST", "/v1/admin/swap")])
def test_unknown_and_gated_routes_are_404_as_in_the_reference(idle_pair,
                                                              method, path):
    ref_url, port_url = idle_pair.urls
    want = _status_and_body(ref_url, method, path)
    assert want[0] == 404
    assert _status_and_body(port_url, method, path) == want


def test_health_readiness_and_status_keys(idle_pair):
    ref_url, port_url = idle_pair.urls
    for path in ("/healthz", "/readyz"):
        assert (_status_and_body(port_url, "GET", path)
                == _status_and_body(ref_url, "GET", path))
    _, want = _status_and_body(ref_url, "GET", "/v1/status")
    _, got = _status_and_body(port_url, "GET", "/v1/status")
    assert set(got) == set(want)
    for key in ("slots", "flightrecord"):
        assert set(got[key]) == set(want[key])
    assert set(got["slo"]["objectives"]) == set(want["slo"]["objectives"])
    assert got["batched"] is True and got["slots"]["total"] == 1
    assert got["slo"] == want["slo"]


def test_debug_routes_behind_the_env_gate(lm, monkeypatch):
    monkeypatch.setenv("KFT_ENABLE_DEBUG_ENDPOINTS", "true")
    pair = Pair(lm, max_batch=1, max_len=64)
    try:
        for url in pair.urls:
            sse_generate(url, [4, 5, 6], 3)
        docs = [{path: _status_and_body(url, "GET", path)
                 for path in ("/debug/profile", "/debug/flightrecord")}
                for url in pair.urls]
        for path in docs[0]:
            assert docs[1][path][0] == docs[0][path][0] == 200
            assert set(docs[1][path][1]) == set(docs[0][path][1])
        profile = docs[1]["/debug/profile"][1]["engine"]
        assert {"admit", "prefill", "decode"} <= set(profile)
        ring = docs[1]["/debug/flightrecord"][1]["snapshots"]
        assert ring and ring[-1]["kind"] == "serve_cycle"
    finally:
        pair.stop()


def test_429_with_retry_after_when_the_inbox_is_full(lm):
    pair = Pair(lm, start=False, max_batch=1, max_len=64, max_pending=2,
                gateway_kw={"ref": {"retry_after_s": 7},
                            "port": {"retry_after_s": 7}})
    body = {"prompt": [1, 2, 3], "max_new_tokens": 4, "stream": False}

    def park(url):
        try:
            _post(url, "/v1/generate", body, timeout=5)
        except (urllib.error.URLError, OSError):
            pass   # parked until its client timeout: no scheduler runs

    try:
        answers = []
        for engine, url in zip((pair.jengine, pair.tengine), pair.urls):
            for _ in range(2):
                threading.Thread(target=park, args=(url,),
                                 daemon=True).start()
            deadline = time.monotonic() + 10
            while engine.pending() < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert engine.pending() == 2
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(url, "/v1/generate", body, timeout=5)
            answers.append((err.value.code, err.value.headers["Retry-After"],
                            json.loads(err.value.read())))
            assert _metric(url, "inference_shed_total") == 1
            assert _metric(url, "inference_queue_depth") == 2
            assert _metric(url, "inference_request_duration_seconds_count",
                           {"outcome": "shed"}) == 1
        assert answers[0][:2] == (429, "7")
        assert answers[1] == answers[0]
    finally:
        pair.stop()


def test_swap_endpoint_404_409_and_200(lm):
    _, _, jparams, tparams = lm
    calls = {"ref": [], "port": []}

    def loader(side, params, found):
        def reload_fn():
            calls[side].append(1)
            return (params if found else None), {"step": 42 if found
                                                 else None}
        return reload_fn

    for found in (False, True):
        pair = Pair(lm, max_batch=1, max_len=64, gateway_kw={
            "ref": {"reload_fn": loader("ref", jparams, found)},
            "port": {"reload_fn": loader("port", tparams, found)}})
        try:
            answers = [_status_and_body(url, "POST", "/v1/admin/swap")
                       for url in pair.urls]
            assert answers[1] == answers[0]
            assert answers[0][0] == (200 if found else 409)
            if found:
                assert answers[0][1] == {"staged": True,
                                         "info": {"step": 42}}
                for engine, url in zip((pair.jengine, pair.tengine),
                                       pair.urls):
                    deadline = time.monotonic() + 30
                    while (engine.swaps_total == 0
                           and time.monotonic() < deadline):
                        time.sleep(0.02)
                    assert _metric(url, "inference_model_swap_total") == 1
        finally:
            pair.stop()
    assert calls == {"ref": [1, 1], "port": [1, 1]}


def test_metrics_schema_equals_the_reference_in_both_formats(lm):
    pytest.importorskip("prometheus_client")
    pair = Pair(lm, max_batch=2, max_len=64)
    try:
        for url in pair.urls:
            sse_generate(url, [9, 8, 7, 6], 4)
            sse_generate(url, [9, 8, 7, 6], 4)   # a prefix-cache hit
            _status_and_body(url, "POST", "/v1/generate", {"prompt": []})
        ref_url, port_url = pair.urls
        for om in (False, True):
            headers = ({"Accept": "application/openmetrics-text"} if om
                       else {})
            scraped = []
            for url in (ref_url, port_url):
                status, hdrs, body = _get(url, "/metrics", headers)
                assert status == 200
                scraped.append((hdrs["Content-Type"],
                                _families(body.decode(), om)))
            (ref_type, want), (port_type, got) = scraped
            assert port_type == ref_type
            assert set(got) == set(want)
            for name in want:
                # Same type, help and label names; the engine's cycle
                # histogram has the same label name, though the port's
                # engine has no speculative verify/commit phases.
                assert got[name] == want[name], name
        assert _metric(port_url, "inference_ttft_seconds_count") == 2
        assert _metric(port_url, "inference_request_duration_seconds_count",
                       {"outcome": "bad_request"}) == 1
    finally:
        pair.stop()


def _drop_after_first_frame(url, prompt, max_new):
    """Send a streaming request on a raw socket, read up to the first
    data frame, and reset the connection (SO_LINGER 0)."""
    host, port = url.removeprefix("http://").split(":")
    sock = socket.create_connection((host, int(port)), timeout=60)
    body = json.dumps({"prompt": prompt, "max_new_tokens": max_new})
    sock.sendall((f"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
    seen = b""
    while b"data: " not in seen:
        chunk = sock.recv(4096)
        assert chunk, "the gateway closed before the first frame"
        seen += chunk
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                    b"\x01\x00\x00\x00\x00\x00\x00\x00")
    sock.close()
    return seen


def test_client_disconnect_is_counted_and_the_next_request_served(lm):
    """The scheduler is driven by hand so the drop lands mid-stream: one
    cycle (prefill + a decode chunk) streams the first frames, the client
    resets, and the cycles after it write into the closed socket."""
    _, tcfg, _, tparams = lm
    pair = Pair(lm, start=False, max_batch=1, max_len=64, step_chunk=4)
    try:
        outcomes = []
        for engine, url in zip((pair.jengine, pair.tengine), pair.urls):
            box = {}
            client = threading.Thread(target=lambda: box.setdefault(
                "seen", _drop_after_first_frame(url, [5, 9, 2, 14], 40)))
            client.start()
            deadline = time.monotonic() + 30
            while engine.pending() < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            engine.step_cycle()
            client.join(timeout=60)
            assert not client.is_alive() and b"data: " in box["seen"]
            engine.drain()
            deadline = time.monotonic() + 30
            while (_metric(url, "inference_request_duration_seconds_count",
                           {"outcome": "disconnect"}) is None
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            outcomes.append(_metric(
                url, "inference_request_duration_seconds_count",
                {"outcome": "disconnect"}))
            # The slot ran to its budget; the next request is served.
            done = {}
            threading.Thread(target=lambda: done.setdefault(
                "out", sse_generate(url, [1, 2, 3], 5)), daemon=True).start()
            deadline = time.monotonic() + 60
            while "out" not in done and time.monotonic() < deadline:
                engine.step_cycle()
                time.sleep(0.01)
            assert done["out"][0] == generate(tcfg, tparams, [[1, 2, 3]], 5,
                                              device="cpu")[0].tolist()
            assert engine.pending() == 0
        assert outcomes == [1, 1]
    finally:
        pair.stop()


def test_sampled_request_is_reproducible_and_equals_the_port_generate(lm):
    _, tcfg, _, tparams = lm
    pair = Pair(lm, max_batch=2, max_len=64)
    try:
        _, port_url = pair.urls
        prompt = [3, 1, 4, 1, 5]
        extra = {"temperature": 0.9, "seed": 1234}
        first = sse_generate(port_url, prompt, 8, extra)[0]
        second = sse_generate(port_url, prompt, 8, extra)[0]
        assert first == second
        want = generate(tcfg, tparams, [prompt], 8, temperature=0.9,
                        rng=1234, device="cpu")[0].tolist()
        assert first == want
        other = sse_generate(port_url, prompt, 8,
                             {"temperature": 0.9, "seed": 99})[0]
        assert other == generate(tcfg, tparams, [prompt], 8, temperature=0.9,
                                 rng=99, device="cpu")[0].tolist()
    finally:
        pair.stop()


def test_request_span_parents_on_the_incoming_traceparent(lm):
    from kubeflow_tpu_torch.obs import trace

    class RecordingTracer(trace.Tracer):
        started = collections.deque(maxlen=16)

        def start_span(self, *args, **kw):
            span = super().start_span(*args, **kw)
            self.started.append(span)
            return span

    tracer = RecordingTracer()
    trace.set_tracer(tracer)
    trace_id, span_id = "ab" * 16, "cd" * 8
    pair = Pair(lm, max_batch=1, max_len=64)
    try:
        _, port_url = pair.urls
        with _post(port_url, "/v1/generate",
                   {"prompt": [1, 2], "max_new_tokens": 2, "stream": False},
                   headers={"traceparent": f"00-{trace_id}-{span_id}-01"}
                   ) as r:
            r.read()
        spans = [s for s in tracer.started
                 if s.name == "inference /v1/generate"]
        assert spans and spans[-1].context.trace_id == trace_id
        assert spans[-1].parent_id == span_id
        assert spans[-1].context.sampled
        # The span's trace id rides the TTFT observation as an exemplar.
        status, _, body = _get(port_url, "/metrics",
                               {"Accept": "application/openmetrics-text"})
        assert status == 200
        ttft = [line for line in body.decode().splitlines()
                if line.startswith("inference_ttft_seconds_bucket")
                and f'trace_id="{trace_id}"' in line]
        assert len(ttft) == 1
    finally:
        pair.stop()
        trace.set_tracer(None)

"""The port's copies of the reference's observability and autopilot
modules, held against the reference on the same inputs.

Every case runs the reference (``kubeflow_tpu.obs``/``autopilot``) and
the port (``kubeflow_tpu_torch.obs``/``autopilot``) side by side and
compares what they return exactly: parsed trace contexts, env knobs,
alert transitions and SLO status on a scripted clock, the admission
actuator's engine settings after each edge, and the exposition text
(Prometheus 0.0.4 and OpenMetrics) of equal registries, the creation
timestamps and exemplar times masked (they are wall-clock reads).
"""

from __future__ import annotations

import collections
import json
import logging
import re

import pytest

from kubeflow_tpu.autopilot import ActuationGuard as RefGuard
from kubeflow_tpu.autopilot import Autopilot as RefAutopilot
from kubeflow_tpu.autopilot import AutopilotCollector as RefCollector
from kubeflow_tpu.autopilot import GatewayAdmissionActuator as RefAdmission
from kubeflow_tpu.obs import alerts as ref_alerts
from kubeflow_tpu.obs import envknob as ref_envknob
from kubeflow_tpu.obs import logging as ref_logging
from kubeflow_tpu.obs import recorder as ref_recorder
from kubeflow_tpu.obs import slo as ref_slo
from kubeflow_tpu.obs import trace as ref_trace
from kubeflow_tpu.obs.metrics import BucketHistogram as RefHistogram
from kubeflow_tpu_torch.autopilot import ActuationGuard, Autopilot
from kubeflow_tpu_torch.autopilot import AutopilotCollector
from kubeflow_tpu_torch.autopilot import GatewayAdmissionActuator
from kubeflow_tpu_torch.obs import alerts, envknob, exposition
from kubeflow_tpu_torch.obs import logging as port_logging
from kubeflow_tpu_torch.obs import recorder, slo, trace
from kubeflow_tpu_torch.obs.metrics import (
    CANONICAL_LABELS,
    LATENCY_BUCKETS,
    REQUEST_BUCKETS,
    BucketHistogram,
)

TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
SPAN_ID = "00f067aa0ba902b7"

TRACEPARENTS = {
    "sampled": f"00-{TRACE_ID}-{SPAN_ID}-01",
    "unsampled": f"00-{TRACE_ID}-{SPAN_ID}-00",
    "future_version_suffix": f"01-{TRACE_ID}-{SPAN_ID}-01-extra",
    "padded": f"  00-{TRACE_ID}-{SPAN_ID}-01  ",
    "flags_other_bits": f"00-{TRACE_ID}-{SPAN_ID}-02",
    "version_ff": f"ff-{TRACE_ID}-{SPAN_ID}-01",
    "zero_trace": f"00-{'0' * 32}-{SPAN_ID}-01",
    "zero_span": f"00-{TRACE_ID}-{'0' * 16}-01",
    "uppercase": f"00-{TRACE_ID.upper()}-{SPAN_ID}-01",
    "short_trace": f"00-{TRACE_ID[:-1]}-{SPAN_ID}-01",
    "missing_flags": f"00-{TRACE_ID}-{SPAN_ID}",
    "empty": "",
    "none": None,
    "garbage": "not-a-traceparent",
}


def _ctx(ctx):
    return None if ctx is None else (ctx.trace_id, ctx.span_id, ctx.sampled)


@pytest.mark.parametrize("name", sorted(TRACEPARENTS))
def test_parse_traceparent_matches_reference(name):
    header = TRACEPARENTS[name]
    want = _ctx(ref_trace.parse_traceparent(header))
    got = _ctx(trace.parse_traceparent(header))
    assert got == want
    if got is not None:
        ctx = trace.SpanContext(*got)
        assert (trace.format_traceparent(ctx)
                == ref_trace.format_traceparent(ref_trace.SpanContext(*want)))


class RecordingTracer(trace.Tracer):
    """A tracer that keeps every span it starts, for the tests to read."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.started = collections.deque(maxlen=16)

    def start_span(self, *args, **kw):
        span = super().start_span(*args, **kw)
        self.started.append(span)
        return span


def test_tracer_parents_on_remote_context_and_inherits_sampling():
    parent = trace.parse_traceparent(TRACEPARENTS["sampled"])
    tracer = RecordingTracer()
    with tracer.span("outer", parent=parent) as outer:
        assert trace.current_span() is outer
        with tracer.span("inner") as inner:
            assert trace.current_span() is inner
        assert trace.current_span() is outer
    assert trace.current_span() is None
    assert outer.context.trace_id == inner.context.trace_id == TRACE_ID
    assert outer.parent_id == SPAN_ID
    assert inner.parent_id == outer.context.span_id
    assert outer.context.sampled and inner.context.sampled
    unsampled = trace.parse_traceparent(TRACEPARENTS["unsampled"])
    with tracer.span("dropped", parent=unsampled) as dropped:
        with tracer.span("child") as child:
            pass
    assert not dropped.context.sampled and not child.context.sampled
    assert dropped.context.trace_id == TRACE_ID
    with pytest.raises(RuntimeError):
        with tracer.span("failing"):
            raise RuntimeError("boom")
    assert trace.current_span() is None
    failing = tracer.started[-1]
    assert failing.name == "failing" and failing.parent_id is None
    assert failing.context.trace_id != TRACE_ID
    assert [s.name for s in tracer.started] == [
        "outer", "inner", "dropped", "child", "failing"]
    never = trace.Tracer(sample_rate=0.0)
    with never.span("root", parent=None) as root:
        assert not root.context.sampled


ENV_CASES = [None, "", "1", "true", "TRUE", "yes", "0", "false", "no",
             "off", "2.5", "-3", "17", "abc", "1e3"]


@pytest.mark.parametrize("raw", ENV_CASES, ids=repr)
def test_env_knobs_match_reference(monkeypatch, raw):
    name = "KFT_TORCH_OBS_TEST_KNOB"
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    for default in (False, True):
        assert (envknob.env_bool(name, default)
                == ref_envknob.env_bool(name, default))
    for kwargs in ({"default": 4}, {"default": 4, "cast": int},
                   {"default": 4, "cast": int, "minimum": 2},
                   {"default": 60.0, "minimum": 0.0}):
        assert (envknob.env_number(name, **kwargs)
                == ref_envknob.env_number(name, **kwargs))


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _slo_run(mod_slo, mod_alerts, hist_cls, tmp_path, side):
    """A scripted TTFT/ITL series on an injected clock: 20 healthy
    minutes, a 30-minute burn (every first token slow, half the gaps
    slow), then 2 hours of recovery; ticks every 5 s. Returns the
    transitions, the final status and the recorder's dump count."""
    clock = Clock()
    ttft = hist_cls(LATENCY_BUCKETS)
    itl = hist_cls(REQUEST_BUCKETS)
    rec_mod = ref_recorder if mod_slo is ref_slo else recorder
    rec = rec_mod.FlightRecorder(dump_dir=str(tmp_path / side),
                                 clock=clock, min_dump_interval_s=600.0)
    evaluator = mod_slo.BurnRateEvaluator(clock=clock)
    engine = mod_alerts.SloEngine(evaluator=evaluator, recorder=rec)
    for objective in (mod_slo.ttft_objective(ttft),
                      mod_slo.itl_objective(itl)):
        if mod_slo is ref_slo:
            objective.source = ref_slo.bucket_histogram_source(
                ttft if objective.name == "inference-ttft" else itl,
                objective.threshold_s)
        engine.register(objective)
    transitions = []
    engine.alerts.subscribe(lambda t: transitions.append(
        (t["slo"], t["speed"], t["from"], t["to"], t["at"], t["burn"])))
    for step in range(int(3.0 * 3600 / 5)):
        clock.t = step * 5.0
        burning = 1200.0 <= clock.t < 3000.0
        for i in range(4):
            ttft.observe(5.0 if burning else 0.2)
            itl.observe(0.5 if burning and i % 2 else 0.02)
        rec.record("serve_cycle", cycle=step)
        engine.tick(clock.t)
    return transitions, engine.status(), rec.dumps_total


def test_slo_engine_gives_the_reference_transitions(tmp_path):
    ref = _slo_run(ref_slo, ref_alerts, RefHistogram, tmp_path, "ref")
    port = _slo_run(slo, alerts, BucketHistogram, tmp_path, "port")
    assert port == ref
    transitions, status, dumps = port
    # The scenario is not vacuous: both pairs fire and resolve.
    fired = {(slo_, speed) for slo_, speed, _, to, _, _ in transitions
             if to == "firing"}
    assert fired == {("inference-ttft", "fast"), ("inference-ttft", "slow"),
                     ("inference-itl", "fast"), ("inference-itl", "slow")}
    assert any(to == "resolved" for *_, to, _, _ in transitions)
    assert dumps >= 1 and status["alerts"] == []


def test_histogram_good_total_matches_reference():
    hist = BucketHistogram(LATENCY_BUCKETS)
    for value in (0.0005, 0.2, 2.5, 2.6, 100.0):
        hist.observe(value)
    snap = hist.snapshot()
    for threshold in (0.001, 0.25, 2.5, 3.0, 1e9):
        assert (slo.histogram_good_total(snap, threshold)
                == ref_slo.histogram_good_total(snap, threshold))


class StubEngine:
    def __init__(self, max_pending=64, prefill_per_cycle=4):
        self.max_pending = max_pending
        self.prefill_per_cycle = prefill_per_cycle


def _transition(slo_="inference-ttft", speed="fast", to="firing",
                severity="critical", at=0.0, frm="pending"):
    return {"kind": "slo_alert", "slo": slo_, "speed": speed,
            "severity": severity, "from": frm, "to": to, "burn": 20.0,
            "at": at, "namespace": None}


# Each script: edges ("t", kwargs), guard-clock advances ("advance", s)
# and ticks ("tick",), from tests/test_autopilot.py TestGatewayAdmission.
ADMISSION_SCRIPTS = {
    "tighten_then_restore": [("t", {}), ("t", {"to": "resolved",
                                               "frm": "firing"})],
    "warning_ignored": [("t", {"speed": "slow", "severity": "warning"})],
    "unwatched_ignored": [("t", {"slo_": "apiserver-availability"})],
    "restore_waits_for_last": [
        ("t", {}), ("t", {"slo_": "inference-itl"}),
        ("t", {"to": "resolved", "frm": "firing"}),
        ("t", {"slo_": "inference-itl", "to": "resolved",
               "frm": "firing"})],
    "flaps": [step for i in range(20) for step in (
        ("t", {"at": float(i)}),
        ("t", {"to": "resolved", "frm": "firing", "at": float(i)}))],
    "second_incident": [("t", {}), ("t", {"to": "resolved",
                                          "frm": "firing"}),
                        ("t", {"slo_": "inference-itl", "at": 1.0})],
    "retry_on_tick": [("t", {}), ("t", {"to": "resolved", "frm": "firing"}),
                      ("t", {}), ("tick",), ("advance", 61.0), ("tick",)],
    "never_compounds": [("t", {}), ("advance", 120.0),
                        ("t", {"slo_": "inference-itl"}),
                        ("t", {"to": "resolved", "frm": "firing"}),
                        ("t", {"slo_": "inference-itl", "to": "resolved",
                               "frm": "firing"})],
}


def _admission_trace(actuator_cls, guard_cls, script):
    clock = Clock()
    engine = StubEngine()
    actions = []
    act = actuator_cls(engine, guard=guard_cls(min_interval_s=60.0,
                                               clock=clock))
    act._emit = lambda outcome, **detail: actions.append(
        (outcome, sorted(detail.items())))
    states = []
    for step in script:
        if step[0] == "t":
            act.on_transition(_transition(**step[1]))
        elif step[0] == "advance":
            clock.t += step[1]
        else:
            act.on_tick()
        states.append((engine.max_pending, engine.prefill_per_cycle,
                       act.tightened))
    return states, actions


@pytest.mark.parametrize("case", sorted(ADMISSION_SCRIPTS))
def test_gateway_admission_actuator_matches_reference(case):
    script = ADMISSION_SCRIPTS[case]
    want = _admission_trace(RefAdmission, RefGuard, script)
    got = _admission_trace(GatewayAdmissionActuator, ActuationGuard, script)
    assert got == want


def test_autopilot_disabled_installs_nothing():
    engine = alerts.SloEngine(evaluator=slo.BurnRateEvaluator(clock=Clock()))
    pilot = Autopilot(enabled=False)
    act = pilot.register(GatewayAdmissionActuator(StubEngine()))
    pilot.attach(engine)
    assert pilot.actuators() == [] and act._emit is None
    assert engine.alerts._subscribers == []


def _mask(text: str) -> str:
    """Blank the wall-clock reads: _created values and exemplar times."""
    text = re.sub(r"^(\S+_created(?:\{[^}]*\})?) \S+$", r"\1 T", text,
                  flags=re.M)
    return re.sub(r"(# \{[^}]*\} \S+) \S+$", r"\1 T", text, flags=re.M)


def _registries():
    """The same metrics, observations and custom families in a
    prometheus_client registry and in the port's."""
    pc = pytest.importorskip("prometheus_client")
    from prometheus_client.core import (
        CounterMetricFamily,
        GaugeMetricFamily,
        HistogramMetricFamily,
    )

    class RefCustom:
        def describe(self):
            return []

        def collect(self):
            fam = CounterMetricFamily("custom_lookups", "Lookups\nby kind",
                                      labels=["outcome"])
            fam.add_metric(["hit"], 3)
            fam.add_metric(["miss"], 0)
            yield fam
            yield GaugeMetricFamily("custom_slots", "Slots", value=8)
            fam = HistogramMetricFamily("custom_cycle_seconds", "Cycles",
                                        labels=["phase"])
            fam.add_metric(["decode"], buckets=snap["buckets"],
                           sum_value=snap["sum"])
            yield fam

    class PortCustom:
        def collect(self):
            fam = exposition.CounterFamily("custom_lookups",
                                           "Lookups\nby kind",
                                           labels=["outcome"])
            fam.add_metric(["hit"], 3)
            fam.add_metric(["miss"], 0)
            yield fam
            fam = exposition.GaugeFamily("custom_slots", "Slots")
            fam.add_metric([], 8)
            yield fam
            fam = exposition.HistogramFamily("custom_cycle_seconds",
                                             "Cycles", labels=["phase"])
            fam.add_metric(["decode"], snap["buckets"], snap["sum"])
            yield fam

    hist = BucketHistogram()
    for value in (0.003, 0.2, 7.0):
        hist.observe(value)
    snap = hist.snapshot()
    sides = []
    for lib, custom in ((pc, RefCustom()), (exposition, PortCustom())):
        reg = (pc.CollectorRegistry() if lib is pc
               else exposition.Registry())
        reg.register(custom)
        dur = lib.Histogram("req_seconds", 'Request "time"', ["outcome"],
                            registry=reg, buckets=LATENCY_BUCKETS)
        ttft = lib.Histogram("first_seconds", "First", registry=reg,
                             buckets=REQUEST_BUCKETS)
        toks = lib.Counter("toks", "Tokens", ["kind"], registry=reg)
        shed = lib.Counter("shed", "Shed", registry=reg)
        depth = lib.Gauge("depth", "Depth", registry=reg)
        depth.set_function(lambda: 5)
        dur.labels("ok").observe(0.3)
        dur.labels("shed").observe(0.0001)
        dur.labels("ok").observe(12345678.0)
        ttft.observe(0.02, exemplar={"trace_id": TRACE_ID})
        ttft.observe(3.0)
        toks.labels("prompt").inc(22)
        toks.labels("generated").inc()
        shed.inc(2)
        sides.append(reg)
    return pc, sides


def test_exposition_renders_like_prometheus_client():
    pc, (ref_reg, port_reg) = _registries()
    from prometheus_client.openmetrics import exposition as om

    ref_text = pc.generate_latest(ref_reg).decode()
    port_text = exposition.render_text(port_reg).decode()
    assert _mask(port_text) == _mask(ref_text)
    ref_om = om.generate_latest(ref_reg).decode()
    port_om = exposition.render_openmetrics(port_reg).decode()
    assert _mask(port_om) == _mask(ref_om)
    assert exposition.CONTENT_TYPE_OPENMETRICS == om.CONTENT_TYPE_LATEST
    assert f'trace_id="{TRACE_ID}"' in port_om
    assert "trace_id" not in port_text


@pytest.mark.parametrize("fmt", ["text", "openmetrics"])
def test_parse_text_reads_what_prometheus_client_reads(fmt):
    pc, (_, port_reg) = _registries()
    from prometheus_client.openmetrics.parser import (
        text_string_to_metric_families as om_parse,
    )
    from prometheus_client.parser import text_string_to_metric_families

    if fmt == "text":
        text = exposition.render_text(port_reg).decode()
        theirs = text_string_to_metric_families(text)
    else:
        text = exposition.render_openmetrics(port_reg).decode()
        theirs = om_parse(text)
    want = sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                  for fam in theirs for s in fam.samples)
    ours = exposition.parse_text(text)
    got = sorted((name, tuple(sorted(labels.items())), value)
                 for fam in ours.values()
                 for name, labels, value in fam["samples"])
    assert got == want
    assert exposition.sample_value(ours, "toks_total",
                                   {"kind": "prompt"}) == 22.0
    assert exposition.sample_value(ours, "first_seconds_count") == 2.0
    assert ours["custom_lookups" if fmt == "openmetrics"
                else "custom_lookups_total"]["help"].startswith("Lookups")


def test_go_float_matches_prometheus_client():
    pytest.importorskip("prometheus_client")
    from prometheus_client.utils import floatToGoString

    for value in (0, 1, 0.001, 2.5, 60.0, 1234567.0, 1.7922e9, -3.25,
                  float("inf"), float("-inf"), float("nan"), 1e-12):
        assert exposition.go_float(value) == floatToGoString(value)


def test_autopilot_collector_families_match_reference():
    pc = pytest.importorskip("prometheus_client")
    ref_pilot = RefAutopilot(enabled=True, tracer=ref_trace.Tracer())
    port_pilot = Autopilot(enabled=True)
    for pilot in (ref_pilot, port_pilot):
        pilot.emit("gateway-admission", "tightened", max_pending=16)
        pilot.emit("gateway-admission", "restored")
        pilot.emit("gateway-admission", "tightened")
    ref_reg = pc.CollectorRegistry()
    ref_reg.register(RefCollector(ref_pilot))
    port_reg = exposition.Registry()
    port_reg.register(AutopilotCollector(port_pilot))
    assert (exposition.render_text(port_reg).decode()
            == pc.generate_latest(ref_reg).decode())
    assert port_pilot.counts() == ref_pilot.counts()
    doc, ref_doc = port_pilot.to_dict(), ref_pilot.to_dict()
    for d in (doc, ref_doc):
        for event in d["events"]:
            event.pop("at")
    assert doc == ref_doc


def test_labels_are_canonical_and_schema_equals_reference():
    from kubeflow_tpu.obs.metrics import CANONICAL_LABELS as REF_LABELS
    from kubeflow_tpu.obs.metrics import LATENCY_BUCKETS as REF_LAT
    from kubeflow_tpu.obs.metrics import REQUEST_BUCKETS as REF_REQ

    assert CANONICAL_LABELS == REF_LABELS
    assert (LATENCY_BUCKETS, REQUEST_BUCKETS) == (REF_LAT, REF_REQ)


def test_json_log_formatter_matches_reference():
    record = logging.LogRecord("kubeflow_tpu_torch.serving", logging.WARNING,
                               __file__, 1, "slot %d failed", (3,), None)
    record.request_id = 7
    record.created = 1_700_000_000.0
    ref_tracer = ref_trace.Tracer()
    port_tracer = trace.Tracer()
    with ref_tracer.span("a") as ref_span:
        want = json.loads(ref_logging.JsonLogFormatter().format(record))
    with port_tracer.span("a") as port_span:
        got = json.loads(port_logging.JsonLogFormatter().format(record))
    assert want.pop("trace_id") == ref_span.context.trace_id
    assert got.pop("trace_id") == port_span.context.trace_id
    want.pop("span_id"), got.pop("span_id")
    assert got == want
    logger = logging.getLogger("kubeflow_tpu_torch")
    propagate, level = logger.propagate, logger.level
    handler = port_logging.configure_structured_logging()
    assert port_logging.configure_structured_logging() is handler
    logger.removeHandler(handler)
    logger.propagate, logger.level = propagate, level


def test_flight_recorder_dumps_like_reference(tmp_path):
    docs = []
    for mod, side in ((ref_recorder, "ref"), (recorder, "port")):
        clock = Clock()
        rec = mod.FlightRecorder(capacity=3, dump_dir=str(tmp_path / side),
                                 min_dump_interval_s=60.0, clock=clock)
        for i in range(5):
            clock.t = float(i)
            rec.record("serve_cycle", cycle=i, trace_id=None)
        first = rec.dump("slo firing")
        suppressed = rec.dump("again")
        forced = rec.dump("forced", force=True)
        lines = [json.loads(x) for x in open(first).read().splitlines()]
        doc = rec.to_dict()
        doc["last_dump_path"] = doc["last_dump_path"].split("/")[-1]
        docs.append((lines, suppressed, forced is not None, doc))
    assert docs[1] == docs[0]

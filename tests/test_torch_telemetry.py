"""Step telemetry and the goodput meter: the port
(``kubeflow_tpu_torch/obs/telemetry.py``, its JSONL sink
``obs/export.py``, ``obs/profile.active_digest`` and the MFU table
``topology.py``) against the JAX package's ``kubeflow_tpu/obs/
telemetry.py`` on the same observe and downtime sequences, driven by
injected clocks.

Equal, record for record: the step records (apart from ``device``, and
``peak_flops`` and ``mfu`` where the two tables' peaks differ), their
JSONL lines, the summaries, the per-phase digests a record carries
inside a profiler activation, the goodput summaries, snapshots and the
gap ``from_snapshot`` charges, and every gauge's value under the
reference's six metric names (the reference's rendered by
``prometheus_client``, the port's by its own exposition, both read with
the port's parser).
"""

from __future__ import annotations

import itertools
import json

import pytest
from prometheus_client import generate_latest

from kubeflow_tpu.obs import profile as ref_profile
from kubeflow_tpu.obs import telemetry as ref
from kubeflow_tpu.obs.slo import goodput_source as ref_goodput_source
from kubeflow_tpu_torch import topology
from kubeflow_tpu_torch.obs import exposition, profile, telemetry
from kubeflow_tpu_torch.obs.slo import goodput_source
from kubeflow_tpu_torch.obs.trace import Tracer

# (batch size, step seconds) of one run: a compile-heavy first step, then
# steady steps with noise.
STEPS = [(8, 1.5), (8, 0.11), (8, 0.1), (8, 0.12), (8, 0.1), (4, 0.05)]
METRICS = ("training_step_time_seconds", "training_examples_per_sec",
           "training_mfu", "training_steps", "train_goodput_ratio",
           "train_downtime_seconds")


class Clock:
    """A clock that advances only when told to."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _ticker(start=1.7e9, step=0.5):
    counter = itertools.count()
    return lambda: start + step * next(counter)


def _pair(**kw):
    """The reference's and the port's meter on the same arguments."""
    return (ref.StepTelemetry(clock=_ticker(), **kw),
            telemetry.StepTelemetry(clock=_ticker(), **kw))


def _drive(meter, steps=STEPS):
    return [meter.observe(b, t) for b, t in steps]


def test_records_and_summary_match_the_reference(tmp_path):
    theirs, ours = (
        ref.StepTelemetry(flops_per_example=1.855e12, peak_flops=989e12,
                          device_kind="cpu", clock=_ticker(),
                          jsonl_path=str(tmp_path / "ref.jsonl")),
        telemetry.StepTelemetry(flops_per_example=1.855e12,
                                peak_flops=989e12, device_kind="cpu",
                                clock=_ticker(),
                                jsonl_path=str(tmp_path / "port.jsonl")))
    assert _drive(ours) == _drive(theirs)
    assert list(ours.records) == list(theirs.records)
    assert ours.summary() == theirs.summary()
    assert ((tmp_path / "port.jsonl").read_text()
            == (tmp_path / "ref.jsonl").read_text())
    # Explicit step numbers advance the counter alike.
    assert ours.observe(8, 0.1, step=40) == theirs.observe(8, 0.1, step=40)
    assert ours.observe(8, 0.1)["step"] == theirs.observe(8, 0.1)["step"]


def test_default_peak_is_the_card_table_and_never_a_tpu_peak():
    """Apart from ``device``, ``peak_flops`` and ``mfu`` (which scales
    with the peak) the records are the reference's; the port's peak comes
    from its H100 table, and off the card is a nominal value that is no
    TPU's."""
    theirs = ref.StepTelemetry(flops_per_example=1e9, device_kind="cpu",
                               clock=_ticker())
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("cpu", topology.NOMINAL_PEAK_FLOPS),
                       ("TPU v5 lite", topology.NOMINAL_PEAK_FLOPS)):
        ours = telemetry.StepTelemetry(flops_per_example=1e9,
                                       device_kind=name, clock=_ticker())
        assert ours.peak_flops == peak
        for (b, t), got, want in zip(STEPS, _drive(ours), _drive(theirs)):
            assert got["mfu"] == round(b / t * 1e9 / peak, 6)
            strip = {"device", "peak_flops", "mfu"}
            assert ({k: v for k, v in got.items() if k not in strip}
                    == {k: v for k, v in want.items() if k not in strip})
        theirs = ref.StepTelemetry(flops_per_example=1e9, device_kind="cpu",
                                   clock=_ticker())
    assert telemetry.StepTelemetry(flops_per_example=1.0, device_kind="cpu",
                                   chips=4).peak_flops == (
        4 * topology.NOMINAL_PEAK_FLOPS)
    tpu_peaks = {197e12, 275e12, 459e12, 918e12}
    assert topology.NOMINAL_PEAK_FLOPS not in tpu_peaks
    assert not tpu_peaks & set(topology.PEAK_BF16_FLOPS.values())
    # Without a card the default device is the CPU.
    assert telemetry.StepTelemetry(flops_per_example=1.0).device_kind == "cpu"


def test_records_stamp_the_active_profiler_digest_like_the_reference():
    theirs, ours = _pair(flops_per_example=1e6, peak_flops=1e12,
                         device_kind="cpu")
    for meter, profiler_cls in ((theirs, ref_profile.PhaseProfiler),
                                (ours, profile.PhaseProfiler)):
        meter.observe(4, 0.1)                      # outside: no phases
        prof = profiler_cls(memory=False)
        for seconds in (0.1, 0.3, 0.2):
            with prof.activate():
                prof.observe("step", seconds)
                prof.observe("fetch", seconds / 10)
                meter.observe(4, seconds)
        assert "phases" not in meter.records[0]
    assert list(ours.records) == list(theirs.records)
    assert ours.records[-1]["phases"]["step"]["n"] == 3
    assert profile.active_digest() is None


def test_records_ring_is_bounded_by_the_env_knob(monkeypatch):
    monkeypatch.setenv("OBS_STEP_RECORDS_MAX", "3")
    theirs, ours = _pair(flops_per_example=1e6, peak_flops=1e12,
                         device_kind="cpu")
    assert _drive(ours) == _drive(theirs)
    assert len(ours.records) == 3 and ours.observed == len(STEPS)
    assert list(ours.records) == list(theirs.records)
    assert ours.summary() == theirs.summary()
    monkeypatch.setenv("OBS_STEP_RECORDS_MAX", "garbage")
    assert telemetry.StepTelemetry(flops_per_example=1.0).records.maxlen == (
        ref.StepTelemetry(flops_per_example=1.0).records.maxlen)


def test_jsonl_failure_never_fails_the_step(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    ours = telemetry.StepTelemetry(flops_per_example=1.0, device_kind="cpu",
                                   jsonl_path=str(blocker / "steps.jsonl"))
    ours.observe(4, 0.1)
    assert ours.jsonl_path is None and len(ours.records) == 1


def _downtime_run(meter_cls, clock, epoch):
    """Steps, a restore that proves cross-topology (re-labelled), a
    checkpoint stall, more steps: the summaries along the way."""
    meter = meter_cls(clock=clock, epoch_clock=epoch)
    out = [meter.summary()]
    for seconds in (0.5, 0.4):
        clock.advance(seconds + 0.05)
        meter.observe_step(seconds)
    with meter.downtime("restore") as span:
        clock.advance(2.0)
        span.kind = "reshard"
    with meter.downtime("checkpoint"):
        clock.advance(0.75)
    clock.advance(0.3)
    meter.observe_step(0.3)
    meter.record_downtime("checkpoint", 0.25)
    out.append(meter.summary())
    out.append(meter.goodput_ratio())
    return meter, out


def test_goodput_meter_matches_the_reference():
    ours, got = _downtime_run(telemetry.GoodputMeter, Clock(), Clock(5000.0))
    theirs, want = _downtime_run(ref.GoodputMeter, Clock(), Clock(5000.0))
    assert got == want
    assert set(got[1]["downtime_s"]) == {"reshard", "checkpoint"}
    assert 0.0 < got[2] <= 1.0
    assert ours.snapshot() == theirs.snapshot()
    assert goodput_source(ours)() == ref_goodput_source(theirs)()
    # A meter before any wall time reads 0, as the reference's does.
    assert (telemetry.GoodputMeter(clock=Clock()).goodput_ratio()
            == ref.GoodputMeter(clock=Clock()).goodput_ratio() == 0.0)


def test_from_snapshot_charges_the_same_gap():
    snaps = []
    for meter_cls in (ref.GoodputMeter, telemetry.GoodputMeter):
        clock, epoch = Clock(), Clock(5000.0)
        meter, _ = _downtime_run(meter_cls, clock, epoch)
        snap = json.loads(json.dumps(meter.snapshot()))
        epoch.advance(42.5)                     # the restart nobody saw
        successor = meter_cls.from_snapshot(snap, clock=Clock(10.0),
                                            epoch_clock=epoch)
        successor.observe_step(0.2)
        snaps.append((successor.summary(), successor.downtime_s))
    assert snaps[0] == snaps[1]
    assert snaps[1][1]["gap"] == pytest.approx(42.5)


def test_downtime_is_a_tracer_span_labelled_with_its_kind():
    class Recording(Tracer):
        def __init__(self):
            super().__init__()
            self.started = []  # analysis: allow[py-unbounded-deque]

        def start_span(self, name, parent=None):
            span = super().start_span(name, parent)
            self.started.append(span)
            return span

    tracer = Recording()
    meter = telemetry.GoodputMeter(clock=Clock(), tracer=tracer)
    with meter.downtime("restore") as span:
        span.kind = "reshard"
    (recorded,) = tracer.started
    assert recorded.name == "train downtime"
    assert recorded.attributes == {"kind": "reshard"}


def _samples(text: str) -> dict:
    """{(name, labels): value} of a scrape, read with the port's parser,
    ``_created`` samples left out (their values are creation times)."""
    out = {}
    for family in exposition.parse_text(text).values():
        for sample in family["samples"]:
            name, labels, value = sample
            if not name.endswith("_created"):
                out[(name, tuple(sorted(labels.items())))] = value
    return out


def test_gauges_carry_the_reference_metrics_and_values():
    theirs, ours = _pair(flops_per_example=1e9, peak_flops=1e12,
                         device_kind="cpu")
    _drive(theirs)
    _drive(ours)
    clock_a, clock_b = Clock(), Clock()
    g_theirs, _ = _downtime_run(ref.GoodputMeter, clock_a, Clock())
    g_ours, _ = _downtime_run(telemetry.GoodputMeter, clock_b, Clock())
    want = {**_samples(generate_latest(theirs.registry).decode()),
            **_samples(generate_latest(g_theirs.registry).decode())}
    got = {**_samples(exposition.render_text(ours.registry).decode()),
           **_samples(exposition.render_text(g_ours.registry).decode())}
    assert got == want
    names = {name for name, _ in got}
    for metric in METRICS:
        assert any(n == metric or n == metric + "_total" for n in names), (
            metric, names)
    assert got[("train_downtime_seconds", (("kind", "reshard"),))] == 2.0
    assert got[("training_steps_total", ())] == len(STEPS)

"""The port's span primitive (``kubeflow_tpu_torch/obs/profile.span``),
the train steps' spans and the loops' step timing, on the CPU.

- Off (no ``torch.profiler`` recording, no ``PhaseProfiler`` active) a
  span is one shared no-op: it never enters ``record_function`` and
  makes no CUDA call, in the steps too.
- Under ``torch.profiler`` one step of the LM and one of ResNet each
  record one ``train.step`` range with ``train.forward``,
  ``train.backward`` and ``train.optimizer`` inside it, in that order;
  ``PhaseProfiler.phase`` lands on the trace the same way.
- ``PhaseProfiler.phase`` keeps its digests and scopes.
- ``run_steps`` and ``run_with_checkpointing`` time a step on the card
  with an event pair read one step late (a fake event here): one sync
  on the first step, none after, one record a step, every step flushed
  before a save and at the end.
"""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kubeflow_tpu_torch.models import train as port_train
from kubeflow_tpu_torch.models.resnet import BottleneckBlock, ResNet
from kubeflow_tpu_torch.models.train import create_train_state, make_train_step
from kubeflow_tpu_torch.models.transformer import (
    LMConfig,
    build_lm,
    create_lm_state,
    make_lm_train_step,
)
from kubeflow_tpu_torch.obs import profile as obs_profile
from kubeflow_tpu_torch.obs.profile import PhaseProfiler, span
from kubeflow_tpu_torch.obs.telemetry import GoodputMeter, StepTelemetry

SPANS = ("train.step", "train.forward", "train.backward", "train.optimizer")


def _lm():
    cfg = LMConfig(vocab=64, layers=1, dim=32, heads=2)
    state = create_lm_state(build_lm(cfg), seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, 64, (2, 16), generator=gen)}
    return state, make_lm_train_step(cfg=cfg), batch


def _resnet():
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=4, width=4)
    state = create_train_state(model, seed=0, input_shape=(2, 16, 16, 3),
                               device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {"image": torch.randn(2, 16, 16, 3, generator=gen),
             "label": torch.tensor([0, 3])}
    return state, make_train_step(), batch


MODELS = {"lm": _lm, "resnet": _resnet}


def _ranges(prof, names):
    """(name, start ns, end ns) of the host ranges named in ``names``,
    in start order."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in names), key=lambda r: r[1])


def _raise(*args, **kwargs):
    raise AssertionError("called with the profiler off")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_span_off_never_enters_record_function_nor_cuda(model,
                                                          monkeypatch):
    for module in (torch.autograd.profiler, torch.profiler):
        monkeypatch.setattr(module, "record_function", _raise)
    for name in ("synchronize", "Event", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, _raise)
    assert span("a") is span("b")          # one shared no-op: no allocation
    with span("train.step"):
        pass
    state, step, batch = MODELS[model]()
    state, metrics = step(state, batch)
    assert state.step == 1 and torch.isfinite(metrics["loss"])


@pytest.mark.parametrize("model", sorted(MODELS))
def test_one_step_under_the_profiler_records_its_four_spans_in_order(model):
    state, step, batch = MODELS[model]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    ranges = _ranges(prof, SPANS)
    assert [name for name, _, _ in ranges] == list(SPANS)
    (_, s0, s1), *parts = ranges
    assert all(s0 <= a <= b <= s1 for _, a, b in parts)
    assert all(prev[2] <= nxt[1] for prev, nxt in zip(parts, parts[1:]))


def test_a_phase_lands_on_the_trace_and_in_the_digest():
    prof = PhaseProfiler(memory=False)
    with profile(activities=[ProfilerActivity.CPU]) as trace:
        with prof.phase("fetch"):
            torch.ones(4).sum()
    assert [name for name, _, _ in _ranges(trace, {"fetch"})] == ["fetch"]
    assert prof.snapshot()["fetch"]["count"] == 1


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_phase_profiler_keeps_its_digests_and_scopes():
    clock = Clock()
    prof = PhaseProfiler(memory=False, clock=clock)
    with prof.phase("outside"):
        clock.advance(0.25)
    with prof.activate() as scope:
        with prof.phase("fetch"):
            clock.advance(0.5)
        with prof.phase("fetch"):
            clock.advance(1.5)
        with span("train.step"):           # the active profiler takes it
            clock.advance(2.0)
        with pytest.raises(KeyError):
            with prof.phase("save"):
                clock.advance(0.125)
                raise KeyError("boom")
        assert obs_profile.active_digest()["fetch"]["n"] == 2
    assert scope == {"fetch": 2.0, "train.step": 2.0, "save": 0.125}
    with span("unseen"):                   # no profiler active: nothing
        clock.advance(1.0)
    snap = prof.snapshot()
    assert sorted(snap) == ["fetch", "outside", "save", "train.step"]
    assert snap["fetch"]["count"] == 2 and snap["fetch"]["total_s"] == 2.0
    assert snap["fetch"]["max_s"] == 1.5 and snap["outside"]["last_s"] == 0.25
    assert obs_profile.active_digest() is None


# ------------------------------------------------ step timing on a card


class FakeCard:
    """Stands in for the card: a clock the steps advance, timing events
    stamped with it, and a count of host reads of a metric (each a sync
    on a real card)."""

    def __init__(self, monkeypatch):
        self.clock = Clock()
        self.events = []
        self.reads = 0
        card = self

        class Event:
            def __init__(self):
                self.t = card.clock.t
                self.synced = False
                card.events.append(self)

            def synchronize(self):
                self.synced = True

            def elapsed_time(self, end):
                assert end.synced
                return (end.t - self.t) * 1e3

        class Loss:
            def __float__(self):
                card.reads += 1
                return 0.5

        self.Loss = Loss
        monkeypatch.setattr(port_train, "_step_device", lambda m: "card")
        monkeypatch.setattr(port_train, "_timing_event",
                            lambda device: Event())

    def step(self, seconds):
        """A step that takes ``seconds[i]`` on the card at its i-th call."""
        durations = iter(seconds)

        def step(state, batch):
            self.clock.advance(next(durations))
            return state + 1, {"loss": self.Loss()}

        return step


SECONDS = [0.5, 0.125, 0.25, 0.375, 0.0625]


def test_run_steps_times_the_card_one_step_late_without_a_sync(
        monkeypatch):
    card = FakeCard(monkeypatch)
    meter = StepTelemetry(flops_per_example=1e6, device_kind="cpu")
    batches = [{"x": [0, 0]} for _ in SECONDS]
    state, _ = port_train.run_steps(card.step(SECONDS), 0, batches,
                                    telemetry=meter)
    assert state == len(SECONDS)
    assert card.reads == 1                 # the first step only
    times = [r["step_time_s"] for r in meter.records]
    assert [r["step"] for r in meter.records] == list(range(len(SECONDS)))
    assert times[1:] == SECONDS[1:]
    # A start and an end event for each step after the first; every end
    # waited on, the last at the loop's end.
    assert len(card.events) == 2 * (len(SECONDS) - 1)
    assert all(e.synced for e in card.events[1::2])


def test_each_step_is_observed_one_step_late(monkeypatch):
    card = FakeCard(monkeypatch)
    timer = port_train._StepTimer()
    seen = []
    for seconds in SECONDS:
        timer.start()
        card.clock.advance(seconds)
        seen.append(timer.stop(2, {"loss": card.Loss()}))
    assert [len(s) for s in seen] == [1, 0, 1, 1, 1]
    assert [s for _, s in seen[2] + seen[3] + seen[4]] == SECONDS[1:4]
    assert not card.events[-1].synced
    assert timer.flush() == [(2, SECONDS[-1])] and timer.flush() == []


class Manager:
    """A checkpoint manager that remembers how many steps the meters had
    counted at each save."""

    process_count = 1

    def __init__(self, meter, goodput):
        self.meter, self.goodput = meter, goodput
        # analysis: allow[py-unbounded-deque] — test double, bounded by the test's save count
        self.saves = []

    def restore_latest_valid(self, state):
        return None

    def save_async(self, step, state):
        self.saves.append((step, self.meter.observed, self.goodput.steps))

    def save(self, step, state):
        self.save_async(step, state)

    def wait(self):
        pass


def test_the_checkpointed_loop_flushes_before_a_save_and_at_the_end(
        monkeypatch):
    card = FakeCard(monkeypatch)
    meter = StepTelemetry(flops_per_example=1e6, device_kind="cpu")
    goodput = GoodputMeter()
    manager = Manager(meter, goodput)
    batches = [{"x": [0]} for _ in SECONDS]
    _, report = port_train.run_with_checkpointing(
        card.step(SECONDS), 0, batches, manager, save_every_steps=2,
        telemetry=meter, goodput=goodput, profiler=PhaseProfiler(
            memory=False), install_signal_handler=False)
    assert report.final_step == len(SECONDS) and card.reads == 1
    assert manager.saves == [(2, 2, 2), (4, 4, 4)]
    assert meter.observed == goodput.steps == len(SECONDS)
    assert [r["step_time_s"] for r in meter.records][1:] == SECONDS[1:]
    assert all("phases" in r for r in meter.records)
    assert goodput.useful_s == pytest.approx(
        sum(SECONDS[1:]) + meter.records[0]["step_time_s"], abs=1e-6)

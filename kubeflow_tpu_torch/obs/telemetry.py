"""Step telemetry (wall time, examples/s, MFU) and goodput for the train
loop and the bench.

The counterpart of ``kubeflow_tpu/obs/telemetry.py``. One meter serves
the loop (``models/train.py``'s ``run_steps`` and
``run_with_checkpointing``) and the bench (``kubeflow_tpu_torch/bench.py``):
:meth:`StepTelemetry.observe` is called once per completed step, with
its wall seconds (on the card the loop's event pair, read one step
late; host-synced elsewhere), and its record goes to

- an in-memory ring (``records``, bounded by ``OBS_STEP_RECORDS_MAX``)
  the caller aggregates (:meth:`StepTelemetry.summary`),
- JSONL (``OBS_JSONL_PATH`` or an explicit path),
- gauges on an :class:`~kubeflow_tpu_torch.obs.exposition.Registry`,
  under the reference's metric names.

The reference's gauges are ``prometheus_client``'s; the port renders
the same names with its own exposition, which needs no
``prometheus_client``.

MFU is achieved FLOP/s over the card's dense bf16 peak from
:mod:`kubeflow_tpu_torch.topology` (the whole group's with ``chips``).
Off the card the nominal peak keeps MFU finite; the value then means
nothing.

:class:`GoodputMeter` sets useful step seconds against the wall clock
across preemptions, restores and reshards, as the reference's does.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Callable

from kubeflow_tpu_torch.obs.envknob import env_number
from kubeflow_tpu_torch.obs.exposition import Counter, Gauge, Registry
from kubeflow_tpu_torch.obs.profile import active_digest

# In-memory record retention: a trainer that runs forever must not grow
# the ring without bound.
_RECORDS_MAX = 4096


def _records_max_from_env() -> int:
    return env_number("OBS_STEP_RECORDS_MAX", _RECORDS_MAX, cast=int,
                      minimum=1)


class StepTelemetry:
    """Per-step records of one training process.

    ``flops_per_example``: the model's training FLOPs per example (for
    the LM, per sequence); ``peak_flops``: the denominator, by default
    the table's entry for ``device_kind``, which defaults to the current
    card's name (``"cpu"`` without one); ``chips`` multiplies it."""

    def __init__(self, flops_per_example: float,
                 peak_flops: float | None = None,
                 device_kind: str | None = None, chips: int = 1,
                 jsonl_path: str | None = None,
                 registry: Registry | None = None,
                 clock: Callable[[], float] = time.time):
        from kubeflow_tpu_torch import topology

        if device_kind is None:
            device_kind = topology.device_name()
        self.flops_per_example = float(flops_per_example)
        if peak_flops is None:
            peak_flops = topology.peak_flops_for_device_name(device_kind)
        self.peak_flops = float(peak_flops) * max(1, int(chips))
        self.device_kind = device_kind
        self.jsonl_path = (jsonl_path if jsonl_path is not None
                           else os.environ.get("OBS_JSONL_PATH"))
        self._clock = clock
        self._lock = threading.Lock()
        self._step = 0
        self.observed = 0
        self.records: deque = deque(maxlen=_records_max_from_env())
        self.registry = registry if registry is not None else Registry()
        self._gauges = {
            "step_time": Gauge(
                "training_step_time_seconds",
                "Wall time of the most recent training step",
                registry=self.registry),
            "examples": Gauge(
                "training_examples_per_sec",
                "Throughput of the most recent training step",
                registry=self.registry),
            "mfu": Gauge(
                "training_mfu",
                "Model FLOPs utilization of the most recent step "
                "(achieved / peak bf16 FLOPs)",
                registry=self.registry),
            "steps": Counter(
                "training_steps",
                "Training steps observed by this process",
                registry=self.registry),
        }
        self._jsonl = None
        if self.jsonl_path:
            from kubeflow_tpu_torch.obs.export import JsonlExporter

            self._jsonl = JsonlExporter(self.jsonl_path)

    def observe(self, batch_size: int, step_time_s: float,
                step: int | None = None, **extra) -> dict:
        """Record one completed step (its wall time); returns the
        record. Inside a profiler activation the record carries the live
        per-phase digest as ``phases``."""
        step_time_s = max(float(step_time_s), 1e-12)
        examples_per_sec = batch_size / step_time_s
        mfu = examples_per_sec * self.flops_per_example / self.peak_flops
        with self._lock:
            if step is None:
                step = self._step
            self._step = step + 1
        record = {
            "kind": "step_telemetry",
            "ts": self._clock(),
            "step": step,
            "batch_size": batch_size,
            "step_time_s": round(step_time_s, 6),
            "examples_per_sec": round(examples_per_sec, 3),
            "mfu": round(mfu, 6),
            "flops_per_example": self.flops_per_example,
            "peak_flops": self.peak_flops,
            "device": self.device_kind,
            **extra,
        }
        if "phases" not in record:
            digest = active_digest()
            if digest is not None:
                record["phases"] = digest
        with self._lock:
            self.observed += 1
            self.records.append(record)
        self._gauges["step_time"].set(step_time_s)
        self._gauges["examples"].set(examples_per_sec)
        self._gauges["mfu"].set(mfu)
        self._gauges["steps"].inc()
        if self._jsonl is not None:
            try:
                self._jsonl.export(record)
            except OSError:
                # Telemetry never fails the step it measures (a
                # read-only checkout, a full disk): the ring and the
                # gauges still carry the record.
                self._jsonl = None
                self.jsonl_path = None
        return record

    @contextlib.contextmanager
    def timed(self, batch_size: int, **extra):
        """``with telemetry.timed(batch):`` around one host-synced step."""
        t0 = time.perf_counter()
        yield
        self.observe(batch_size, time.perf_counter() - t0, **extra)

    def summary(self) -> dict:
        """Median of the retained steps (the first left out when there is
        more than one: it carries the warm-up), and ``steps``, every step
        observed."""
        with self._lock:
            records = list(self.records)
            observed = self.observed
        if not records:
            return {"steps": 0}
        steady = records[1:] if len(records) > 1 else records
        times = sorted(r["step_time_s"] for r in steady)
        mid = times[len(times) // 2]
        examples = steady[-1]["batch_size"] / mid
        return {
            "steps": observed,
            "median_step_time_s": round(mid, 6),
            "examples_per_sec": round(examples, 3),
            "mfu": round(examples * self.flops_per_example
                         / self.peak_flops, 6),
            "device": self.device_kind,
        }


class _DowntimeSpan:
    """What a :meth:`GoodputMeter.downtime` block may re-label: set
    ``.kind`` before the block exits (a restore that proves
    cross-topology becomes a ``reshard``)."""

    def __init__(self, kind: str):
        self.kind = kind


class GoodputMeter:
    """Useful step seconds against the wall clock across preemptions,
    restores and reshards.

    It accumulates ``useful_s`` (wall seconds of completed steps,
    :meth:`observe_step`) and ``downtime_s`` by kind (measured spans of
    known non-work, :meth:`downtime`, each also a span on the obs
    tracer), against a wall clock running since construction, or since
    the lineage began when resumed with :meth:`from_snapshot`, which
    charges the gap between two incarnations as ``downtime["gap"]``. The
    ratio is the ``train_goodput_ratio`` gauge, the downtime totals
    ``train_downtime_seconds{kind}``."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 epoch_clock: Callable[[], float] = time.time,
                 registry: Registry | None = None, tracer=None):
        self._clock = clock
        self._epoch_clock = epoch_clock
        self._tracer = tracer
        self._lock = threading.Lock()
        self._started = clock()
        self._carried_wall_s = 0.0
        self.useful_s = 0.0
        self.steps = 0
        self.downtime_s: dict[str, float] = {}
        self.registry = registry if registry is not None else Registry()
        self._gauges = {
            "ratio": Gauge(
                "train_goodput_ratio",
                "Useful-step seconds / wall-clock seconds across "
                "preempt, restore and reshard cycles",
                registry=self.registry),
            "useful": Gauge(
                "train_useful_step_seconds",
                "Cumulative host-synced seconds spent in completed "
                "training steps",
                registry=self.registry),
            "downtime": Gauge(
                "train_downtime_seconds",
                "Cumulative measured non-work seconds by kind",
                ["kind"], registry=self.registry),
        }

    def observe_step(self, seconds: float) -> None:
        """One completed training step of ``seconds``."""
        with self._lock:
            self.useful_s += max(float(seconds), 0.0)
            self.steps += 1
        self._export()

    def record_downtime(self, kind: str, seconds: float) -> None:
        with self._lock:
            self.downtime_s[kind] = (self.downtime_s.get(kind, 0.0)
                                     + max(float(seconds), 0.0))
        self._export()

    @contextlib.contextmanager
    def downtime(self, kind: str):
        """``with meter.downtime("restore") as span:`` around a known
        non-work interval, which may re-label itself through
        ``span.kind``; also a ``train downtime`` span on the tracer,
        its ``kind`` an attribute."""
        from kubeflow_tpu_torch.obs.trace import get_tracer

        handle = _DowntimeSpan(kind)
        tracer = self._tracer if self._tracer is not None else get_tracer()
        t0 = self._clock()
        with tracer.span("train downtime") as span:
            try:
                yield handle
            finally:
                span.set_attribute("kind", handle.kind)
                self.record_downtime(handle.kind, self._clock() - t0)

    def wall_s(self) -> float:
        with self._lock:
            return self._carried_wall_s + (self._clock() - self._started)

    def goodput_ratio(self) -> float:
        """useful / wall in [0, 1]; 0.0 before any wall time elapsed."""
        wall = self.wall_s()
        if wall <= 0:
            return 0.0
        with self._lock:
            return min(self.useful_s / wall, 1.0)

    def summary(self) -> dict:
        with self._lock:
            downtime = dict(self.downtime_s)
            useful = self.useful_s
            steps = self.steps
        return {
            "kind": "goodput",
            "wall_s": round(self.wall_s(), 6),
            "useful_step_s": round(useful, 6),
            "steps": steps,
            "downtime_s": {k: round(v, 6)
                           for k, v in sorted(downtime.items())},
            "goodput_ratio": round(self.goodput_ratio(), 6),
        }

    def _export(self) -> None:
        self._gauges["ratio"].set(self.goodput_ratio())
        with self._lock:
            self._gauges["useful"].set(self.useful_s)
            for kind, total in self.downtime_s.items():
                self._gauges["downtime"].labels(kind).set(total)

    def snapshot(self) -> dict:
        """Carryable state: wall, useful and downtime so far, and the
        epoch instant it was taken (:meth:`from_snapshot` charges the
        gap)."""
        with self._lock:
            return {
                "wall_s": self._carried_wall_s
                + (self._clock() - self._started),
                "useful_s": self.useful_s,
                "steps": self.steps,
                "downtime_s": dict(self.downtime_s),
                "saved_at": self._epoch_clock(),
            }

    @classmethod
    def from_snapshot(cls, snap: dict, **kwargs) -> "GoodputMeter":
        """A successor's meter: the predecessor's totals, plus the time
        between its snapshot and now, which neither process measured, as
        wall time and ``downtime["gap"]``."""
        meter = cls(**kwargs)
        with meter._lock:
            meter._carried_wall_s = float(snap.get("wall_s", 0.0))
            meter.useful_s = float(snap.get("useful_s", 0.0))
            meter.steps = int(snap.get("steps", 0))
            meter.downtime_s = {
                str(k): float(v)
                for k, v in (snap.get("downtime_s") or {}).items()}
            saved_at = snap.get("saved_at")
            if saved_at is not None:
                gap = max(float(meter._epoch_clock()) - float(saved_at), 0.0)
                if gap > 0:
                    meter._carried_wall_s += gap
                    meter.downtime_s["gap"] = (
                        meter.downtime_s.get("gap", 0.0) + gap)
        meter._export()
        return meter


__all__ = ["GoodputMeter", "StepTelemetry"]

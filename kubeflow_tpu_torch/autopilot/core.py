"""Autopilot core: alert-driven actuation with bounded authority.

A copy of ``kubeflow_tpu/autopilot/core.py`` for the port's gateway.
Observed burn rates become inputs to admission (the SRE "error-budget
policy as code" pattern), under three disciplines:

- **Bounded authority.** Every actuator is rate-limited
  (:class:`ActuationGuard`) and rides the alert state machine's own
  ``for_s``/``clear_s`` hysteresis, so a flapping SLI produces a bounded
  number of actions.
- **Every actuation is observable**: a counter
  (``autopilot_actions_total{actuator,outcome}`` via
  :class:`AutopilotCollector`), a structured log record, an entry in a
  bounded event log and a flight-recorder snapshot. (The reference also
  stamps a zero-duration span for its span ring, which the port does
  not keep.)
- **Fully disableable.** ``KFT_AUTOPILOT=0`` (or ``enabled=False``)
  makes :meth:`Autopilot.register`/:meth:`Autopilot.attach` inert.

Actuators are driven by :meth:`Autopilot.on_transition` (alert edges,
through :meth:`~kubeflow_tpu_torch.obs.alerts.AlertManager.subscribe`)
and :meth:`Autopilot.tick` (sustained signals, self-rate-limited).

Environment:

- ``KFT_AUTOPILOT``                — "0"/"false" disables the layer
  (default on).
- ``KFT_AUTOPILOT_MIN_INTERVAL_S`` — default :class:`ActuationGuard`
  interval (default 60).
"""

from __future__ import annotations

import functools
import logging
import threading
import time
from collections import deque
from typing import Callable

from kubeflow_tpu_torch.obs.envknob import env_bool, env_number

log = logging.getLogger(__name__)


def autopilot_enabled() -> bool:
    """The master switch: ``KFT_AUTOPILOT=0`` turns every actuator off
    (instrument-only behaviour, identical to the pre-autopilot
    platform)."""
    return env_bool("KFT_AUTOPILOT", True)


def default_guard_interval_s() -> float:
    return env_number("KFT_AUTOPILOT_MIN_INTERVAL_S", 60.0,
                      minimum=0.0)


class ActuationGuard:
    """Rate limit every actuator must hold: at most one action per
    ``min_interval_s`` per key. The guard is the floor of the bounded-
    authority contract — edge hysteresis (alert ``for_s``/``clear_s``)
    and hold windows bound *when* an actuator decides; the guard bounds
    how *often* it may act no matter what upstream decides."""

    def __init__(self, min_interval_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if min_interval_s is None:
            min_interval_s = default_guard_interval_s()
        self.min_interval_s = float(min_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._last: dict[str, float] = {}
        self.allowed = 0
        self.suppressed = 0

    def allow(self, key: str = "default") -> bool:
        """Check-and-reserve: True at most once per interval per key."""
        now = self._clock()
        with self._lock:
            last = self._last.get(key)
            if (last is not None
                    and now - last < self.min_interval_s):
                self.suppressed += 1
                return False
            self._last[key] = now
            self.allowed += 1
            return True


class Actuator:
    """Base shape the :class:`Autopilot` drives.

    Subclasses override :meth:`on_transition` (alert edges) and/or
    :meth:`on_tick` (sustained signals) and call :meth:`record` for
    every action they take; ``register()`` binds ``record`` to the
    autopilot's emit pipeline (count + event + log + flight
    recorder). Every subclass holds an :class:`ActuationGuard`."""

    name = "actuator"

    def __init__(self, guard: ActuationGuard | None = None):
        self.guard = guard if guard is not None else ActuationGuard()
        self._emit: Callable | None = None

    def record(self, outcome: str, **detail) -> None:
        if self._emit is not None:
            self._emit(outcome, **detail)

    def on_transition(self, transition: dict) -> None:
        """One alert state transition (the ``AlertManager`` event
        schema: slo/speed/severity/from/to/burn/at)."""

    def on_tick(self, now: float | None = None) -> None:
        """One sustained-signal evaluation pass."""


class Autopilot:
    """The actuator registry + the observability pipeline every action
    flows through. See the module docstring for the three disciplines.

    ``tick`` is self-rate-limited like ``SloEngine.tick`` (controller
    tick hooks fire tens of times per second); an explicit ``now``
    always runs — deterministic tests and the game-day harness drive
    the clock themselves."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        recorder=None,
        history_limit: int = 256,
        min_interval_s: float = 5.0,
        enabled: bool | None = None,
    ):
        self.enabled = (autopilot_enabled() if enabled is None
                        else bool(enabled))
        self.clock = clock
        # Flight-recorder hop: every action leaves a snapshot in the
        # same ring an alert dump captures, so a dump carries the
        # actuations leading into (and out of) the incident.
        self.recorder = recorder
        self.min_interval_s = float(min_interval_s)
        self._last_tick: float | None = None
        self._lock = threading.Lock()
        self._actuators: dict[str, Actuator] = {}
        # (actuator, outcome) -> count; AutopilotCollector renders it
        # as autopilot_actions_total{actuator,outcome}.
        self.actions_total: dict[tuple[str, str], int] = {}
        # Bounded recent-events view (the /v1/status tail) + the
        # unbounded emitted counter: consistency checks must compare
        # counter-to-counter, never counter-to-ring.
        self.events: deque = deque(maxlen=max(1, int(history_limit)))
        self.events_emitted = 0

    # ---- wiring ----------------------------------------------------------
    def register(self, actuator: Actuator) -> Actuator:
        """Add one actuator and bind its ``record`` to this autopilot's
        emit pipeline. Inert when disabled — the actuator is returned
        unbound and will never be driven."""
        if not self.enabled:
            return actuator
        with self._lock:
            self._actuators[actuator.name] = actuator
        actuator._emit = functools.partial(self.emit, actuator.name)
        return actuator

    def actuators(self) -> list[Actuator]:
        with self._lock:
            return list(self._actuators.values())

    def attach(self, slo_engine) -> "Autopilot":
        """Subscribe to an engine's alert transitions (callable more
        than once — the game day attaches both the manager and the
        gateway engines). No-op when disabled: the subscription is
        never installed, so the engine behaves exactly as it did
        without an autopilot."""
        if not self.enabled or slo_engine is None:
            return self
        slo_engine.alerts.subscribe(self.on_transition)
        if self.recorder is None:
            self.recorder = getattr(slo_engine, "recorder", None)
        return self

    # ---- driving ---------------------------------------------------------
    def on_transition(self, transition: dict) -> None:
        """Fan one alert transition to every actuator, each isolated:
        one failing actuator never blocks the others (or alerting —
        the AlertManager already isolates this whole callback)."""
        if not self.enabled:
            return
        for actuator in self.actuators():
            try:
                actuator.on_transition(transition)
            except Exception:
                log.exception(
                    "autopilot actuator %s failed on transition %s/%s "
                    "-> %s", actuator.name, transition.get("slo"),
                    transition.get("speed"), transition.get("to"),
                )
                self.emit(actuator.name, "error", stage="transition")

    def tick(self, now: float | None = None) -> None:
        """Drive every actuator's sustained-signal pass. Rate-limited
        to ``min_interval_s`` unless ``now`` is explicit."""
        if not self.enabled:
            return
        forced = now is not None
        now = self.clock() if now is None else now
        with self._lock:
            if (not forced and self._last_tick is not None
                    and now - self._last_tick < self.min_interval_s):
                return
            self._last_tick = now
        for actuator in self.actuators():
            try:
                actuator.on_tick(now)
            except Exception:
                log.exception("autopilot actuator %s failed on tick",
                              actuator.name)
                self.emit(actuator.name, "error", stage="tick")

    # ---- the observability pipeline --------------------------------------
    def emit(self, actuator: str, outcome: str, **detail) -> dict:
        """One actuation into every view: counter, bounded event log,
        structured log record, flight-recorder snapshot. Returns the event dict."""
        event = {
            "kind": "autopilot_action",
            "actuator": actuator,
            "outcome": outcome,
            **detail,
            "at": self.clock(),
        }
        with self._lock:
            key = (actuator, outcome)
            self.actions_total[key] = self.actions_total.get(key, 0) + 1
            self.events.append(event)
            self.events_emitted += 1
        log.info(
            "autopilot %s: %s%s", actuator, outcome,
            f" ({detail})" if detail else "",
        )
        if self.recorder is not None:
            try:
                self.recorder.record(
                    "autopilot_action", actuator=actuator,
                    outcome=outcome,
                    detail={k: v for k, v in detail.items()},
                )
            except Exception:
                log.debug("autopilot recorder hop failed",
                          exc_info=True)
        return event

    # ---- reading ---------------------------------------------------------
    def counts(self) -> dict[str, int]:
        """``{"actuator/outcome": n}`` — the in-process view of
        ``autopilot_actions_total``."""
        with self._lock:
            return {
                f"{actuator}/{outcome}": n
                for (actuator, outcome), n in sorted(
                    self.actions_total.items()
                )
            }

    def to_dict(self, events: int = 8) -> dict:
        """The ``/v1/status`` autopilot block: enabled flag, per-
        (actuator, outcome) counts, the most recent events."""
        with self._lock:
            recent = list(self.events)[-max(0, int(events)):]
            counts = {
                f"{actuator}/{outcome}": n
                for (actuator, outcome), n in sorted(
                    self.actions_total.items()
                )
            }
        return {
            "enabled": self.enabled,
            "actuators": sorted(self._actuators),
            "actions": counts,
            "events": recent,
        }


class AutopilotCollector:
    """Exposition view of one :class:`Autopilot`:
    ``autopilot_actions_total{actuator,outcome}`` and
    ``autopilot_enabled``, registered into the gateway's registry
    (``obs/exposition.py``) by the embedding process."""

    def __init__(self, autopilot: Autopilot):
        self.autopilot = autopilot

    def describe(self):
        return []

    def collect(self):
        from kubeflow_tpu_torch.obs.exposition import (
            CounterFamily,
            GaugeFamily,
        )

        fam = CounterFamily(
            "autopilot_actions",
            "Autopilot actuations by actuator and outcome",
            labels=["actuator", "outcome"],
        )
        with self.autopilot._lock:
            items = sorted(self.autopilot.actions_total.items())
        for (actuator, outcome), count in items:
            fam.add_metric([actuator, outcome], count)
        yield fam
        enabled = GaugeFamily(
            "autopilot_enabled",
            "1 when the autopilot layer is active, 0 when disabled "
            "(KFT_AUTOPILOT=0)",
        )
        enabled.add_metric([], 1 if self.autopilot.enabled else 0)
        yield enabled

"""Alert state machine over burn-rate evaluations (stdlib only).

A trimmed copy of ``kubeflow_tpu/obs/alerts.py`` as far as the port's
gateway uses it. :class:`AlertManager` consumes the rows
:meth:`BurnRateEvaluator.tick` produces and tracks one alert per
(objective, window pair):

    inactive --condition--> pending --held for_s--> firing
    pending --clear--> inactive
    firing --clear for clear_s--> resolved (-> inactive)

Every transition is appended to a bounded history and logged (the
reference also stamps it as a zero-duration span for its span ring,
which the port does not keep). :meth:`AlertManager.subscribe` registers
callbacks run once per transition, outside the manager's lock: the
autopilot's actuators ride these edges.

:class:`SloEngine` is what the gateway embeds: evaluator + alert manager
+ a self-rate-limited ``tick`` safe to call from scrape and status
handlers; a pending->firing transition dumps the engine's flight
recorder. The reference's read views for its ``/debug/alerts`` and
``/fleet`` pages are left out.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable

from kubeflow_tpu_torch.obs.slo import BurnRateEvaluator

log = logging.getLogger(__name__)

INACTIVE = "inactive"
PENDING = "pending"
FIRING = "firing"


class AlertManager:
    """Pending/firing/resolved tracking for every (slo, speed) pair."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        history_limit: int = 256,
    ):
        self.clock = clock
        # (slo, speed) -> alert record (mutated in place).
        self._alerts: dict[tuple[str, str], dict] = {}
        # Transition subscribers: one entry per registered actuator,
        # fixed at wiring time.  # analysis: allow[py-unbounded-deque]
        self._subscribers: list[Callable[[dict], None]] = []
        self.history: deque = deque(maxlen=max(1, int(history_limit)))
        # update() runs on scrape and status threads while other handler
        # threads read; iterating _alerts/history during an insert or
        # append raises RuntimeError, so writes and reads share this lock.
        self._lock = threading.Lock()

    # ---- subscriptions ---------------------------------------------------
    def subscribe(self, callback: Callable[[dict], None]):
        """Register ``callback(transition_event)`` for every state
        transition this manager records. Callbacks run on whatever
        thread called :meth:`update` (scrape and status handlers),
        OUTSIDE the manager lock — a callback may read the alert state
        back (``all``) without deadlock, and a slow actuator never
        stalls evaluation. Exceptions are
        logged and isolated per callback. Returns ``callback`` so the
        method composes as a decorator."""
        with self._lock:
            self._subscribers.append(callback)
        return callback

    # ---- updates ---------------------------------------------------------
    def update(self, rows: list[dict], now: float | None = None,
               notify: bool = True) -> list[dict]:
        """Advance every alert against one evaluation; returns the
        transitions that happened (also recorded in ``history``).
        With ``notify`` (the default) subscribers are dispatched here,
        outside this manager's lock; a caller holding its OWN lock
        around ``update`` (``SloEngine.tick``) passes ``notify=False``
        and calls :meth:`notify` after releasing it — subscriber code
        must never run under ANY evaluation lock."""
        now = self.clock() if now is None else now
        transitions: list[dict] = []
        with self._lock:
            self._update_locked(rows, now, transitions)
        if notify:
            self.notify(transitions)
        return transitions

    def notify(self, transitions: list[dict]) -> None:
        """Dispatch ``transitions`` to every subscriber (the dump
        discipline: no lock held — actuators routinely read alert
        state back, tick the owning engine, and perform their own
        locked bookkeeping). Exceptions are logged and isolated per
        callback."""
        if not transitions:
            return
        with self._lock:
            subscribers = list(self._subscribers)
        for transition in transitions:
            for callback in subscribers:
                try:
                    callback(transition)
                except Exception:
                    # One failing actuator must never block alerting or
                    # the other actuators.
                    log.exception(
                        "alert subscriber %r failed on %s/%s -> %s",
                        callback, transition["slo"],
                        transition["speed"], transition["to"],
                    )

    def _update_locked(self, rows: list[dict], now: float,
                       transitions: list[dict]) -> None:
        for row in rows:
            for speed, win in row.get("windows", {}).items():
                key = (row["slo"], speed)
                alert = self._alerts.get(key)
                if alert is None:
                    alert = self._alerts[key] = {
                        "slo": row["slo"],
                        "speed": speed,
                        "severity": win.get("severity", "warning"),
                        "namespace": row.get("namespace"),
                        "state": INACTIVE,
                        "since": now,
                        "pending_since": None,
                        "clear_since": None,
                        "burn": 0.0,
                    }
                alert["burn"] = win.get("burn", 0.0)
                alert["factor"] = win.get("factor")
                alert["namespace"] = row.get("namespace")
                if win.get("violated"):
                    alert["clear_since"] = None
                    if alert["state"] == INACTIVE:
                        alert["pending_since"] = now
                        self._move(alert, PENDING, now, transitions)
                    if (
                        alert["state"] == PENDING
                        and now - alert["pending_since"]
                        >= win.get("for_s", 0.0)
                    ):
                        self._move(alert, FIRING, now, transitions)
                else:
                    if alert["state"] == PENDING:
                        alert["pending_since"] = None
                        self._move(alert, INACTIVE, now, transitions)
                    elif alert["state"] == FIRING:
                        if alert["clear_since"] is None:
                            alert["clear_since"] = now
                        if (
                            now - alert["clear_since"]
                            >= win.get("clear_s", 0.0)
                        ):
                            self._move(alert, INACTIVE, now, transitions,
                                       resolved=True)

    def _move(self, alert: dict, state: str, now: float,
              transitions: list[dict], resolved: bool = False) -> None:
        previous = alert["state"]
        alert["state"] = state
        alert["since"] = now
        event = {
            "kind": "slo_alert",
            "slo": alert["slo"],
            "speed": alert["speed"],
            "severity": alert["severity"],
            "namespace": alert.get("namespace"),
            "from": previous,
            "to": "resolved" if resolved else state,
            "burn": round(float(alert.get("burn", 0.0)), 3),
            "at": now,
        }
        self.history.append(event)
        transitions.append(event)
        level = logging.WARNING if state == FIRING else logging.INFO
        log.log(
            level,
            "slo alert %s: %s/%s (severity=%s burn=%.1fx namespace=%s)",
            event["to"], alert["slo"], alert["speed"], alert["severity"],
            event["burn"], alert.get("namespace") or "-",
        )

    # ---- reads (snapshots under the writer lock) -------------------------
    def all(self) -> list[dict]:
        with self._lock:
            return [dict(a) for a in self._alerts.values()]


class SloEngine:
    """Evaluator + alerts behind one self-rate-limited ``tick``.

    ``tick`` is wired into the gateway's scrape and status handlers —
    call sites that fire tens of times per second — so it samples at
    most every ``min_interval_s`` unless forced (tests force with an
    explicit ``now``)."""

    def __init__(
        self,
        evaluator: BurnRateEvaluator | None = None,
        alerts: AlertManager | None = None,
        min_interval_s: float = 5.0,
        clock: Callable[[], float] | None = None,
        recorder=None,
    ):
        self.evaluator = evaluator or BurnRateEvaluator()
        if clock is None:
            clock = self.evaluator.clock
        self.clock = clock
        self.alerts = alerts or AlertManager(clock=clock)
        self.min_interval_s = float(min_interval_s)
        # Black-box capture (obs.recorder.FlightRecorder): a pending→
        # firing transition dumps the recorder's ring as a JSONL
        # artifact — the window leading up to the alert, captured
        # before anyone asks. The recorder rate-limits itself; a
        # failed/suppressed dump never fails the tick.
        self.recorder = recorder
        # tick() is called from HTTP handler threads (/metrics,
        # /v1/status) concurrently; one lock serializes
        # the sample→evaluate→alert pipeline and the last_rows publish.
        self._lock = threading.Lock()
        self._last_tick: float | None = None
        self.last_rows: list[dict] = []

    def register(self, objective):
        return self.evaluator.register(objective)

    def tick(self, now: float | None = None) -> list[dict]:
        """Sample, evaluate, advance alerts. An explicit ``now`` always
        runs (deterministic tests drive the clock themselves); without
        one the call is rate-limited to ``min_interval_s``."""
        forced = now is not None
        now = self.clock() if now is None else now
        with self._lock:
            if (
                not forced
                and self._last_tick is not None
                and now - self._last_tick < self.min_interval_s
            ):
                return self.last_rows
            self._last_tick = now
            self.last_rows = self.evaluator.tick(now)
            # notify=False: subscriber dispatch must not run under
            # THIS engine's lock either — an actuator reading
            # signal()/status() back would deadlock, and a slow one
            # would stall every concurrent /v1/status and scrape
            # tick. Dispatched below, after release.
            transitions = self.alerts.update(self.last_rows, now,
                                             notify=False)
            rows = self.last_rows
        # Subscribers first (their actions land in the flight ring),
        # then the dump — a black box captured for this very edge
        # carries the actuations it triggered. Both run OUTSIDE the
        # engine lock: a slow disk or actuator during an incident must
        # not stall every concurrent status read behind it.
        self.alerts.notify(transitions)
        if self.recorder is not None:
            fired = [t for t in transitions if t["to"] == FIRING]
            if fired:
                t = fired[0]
                self.recorder.dump(
                    f"slo {t['slo']}/{t['speed']} firing "
                    f"(burn {t['burn']}x)"
                )
        return rows

    def signal(self) -> dict:
        """ONE coherent snapshot of the judging layer as a plain dict:
        per-objective burn rates + alert states, read once (one locked
        rows read + one alerts snapshot)."""
        with self._lock:
            rows = list(self.last_rows)
        alerts = {(a["slo"], a["speed"]): a for a in self.alerts.all()}
        objectives = {}
        for row in rows:
            objectives[row["slo"]] = {
                "target": row["target"],
                "threshold_s": row["threshold_s"],
                "burn": {
                    speed: round(win["burn"], 3)
                    for speed, win in row["windows"].items()
                },
                "states": {
                    speed: alerts.get(
                        (row["slo"], speed), {}
                    ).get("state", INACTIVE)
                    for speed in row["windows"]
                },
            }
        active = [a for a in alerts.values() if a["state"] != INACTIVE]
        return {
            "objectives": objectives,
            "alerts": active,
            "firing": sum(1 for a in active if a["state"] == FIRING),
        }

    def status(self) -> dict:
        """The JSON block the gateway's ``/v1/status`` embeds: a thin
        view of :meth:`signal` (same coherent read)."""
        sig = self.signal()
        return {
            "objectives": sig["objectives"],
            "alerts": sig["alerts"],
        }

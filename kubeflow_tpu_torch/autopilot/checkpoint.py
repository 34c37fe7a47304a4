"""Alert-aware checkpoint cadence.

A copy of ``kubeflow_tpu/autopilot/checkpoint.py`` on the port's
autopilot core and alert states.

The cheapest insurance the platform can buy during an incident is a
fresher checkpoint: when a degrade looks imminent — a critical burn-
rate alert firing, or the capacity timeline shrinking under the slice —
the cost of losing a cadence of steps spikes while the cost of an
extra save does not. :class:`CheckpointCadenceActuator` folds both
signals into one ``factor()`` that
``run_with_checkpointing(cadence_signal=...)`` consults at each step
boundary: 1.0 in fair weather, ``tighten_factor`` (< 1, i.e. save that
much *sooner*) while the weather is bad.

SPMD discipline is preserved by construction: the training loop
consults the signal only when building process 0's view of the step-
boundary decision, then broadcasts the agreed token — ranks never act
on divergent local readings (the same contract SIGTERM and wall-clock
cadence already follow).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable

from kubeflow_tpu_torch.autopilot.core import ActuationGuard, Actuator
from kubeflow_tpu_torch.obs.alerts import FIRING

log = logging.getLogger(__name__)


class CheckpointCadenceActuator(Actuator):
    """Tightens the save cadence while a degrade looks imminent.

    Two inputs, OR-ed:

    - **alert edges** (:meth:`on_transition`): any *critical* firing
      alert — or, with ``objectives``, any firing alert from that set
      regardless of severity — marks the weather bad until it
      resolves.
    - **capacity trend** (:meth:`on_tick` + ``capacity_fn``): a
      shrinking schedulable-chip reading (this tick lower than the
      last) marks it bad until a reading regrows to at least the
      previous level; ``None`` readings (unbounded pool) clear it.

    ``factor()`` is the multiplier applied to the configured save
    interval — 0.25 means "save four times as often". The actuator
    performs no writes itself (the training loop owns the save); the
    guard bounds how often the tighten *edge* is emitted as an action.
    """

    name = "checkpoint-cadence"

    def __init__(self, objectives=None, tighten_factor: float = 0.25,
                 capacity_fn: Callable[[], int | None] | None = None,
                 guard: ActuationGuard | None = None):
        super().__init__(guard=guard)
        self.objectives = (None if objectives is None
                           else frozenset(objectives))
        self.tighten_factor = min(1.0, max(0.05, float(tighten_factor)))
        self.capacity_fn = capacity_fn
        self._lock = threading.Lock()
        self._firing: set[tuple[str, str]] = set()
        self._capacity_shrinking = False
        self._last_capacity: int | None = None
        self._tight = False

    def _relevant(self, transition: dict) -> bool:
        if self.objectives is not None:
            return transition.get("slo") in self.objectives
        return transition.get("severity") == "critical"

    def on_transition(self, transition: dict) -> None:
        if not self._relevant(transition):
            return
        key = (transition["slo"], transition["speed"])
        with self._lock:
            if transition.get("to") == FIRING:
                self._firing.add(key)
            elif transition.get("to") in ("resolved", "inactive"):
                self._firing.discard(key)
        self._update_edge(slo=transition["slo"],
                          to=transition.get("to"))

    def on_tick(self, now: float | None = None) -> None:
        if self.capacity_fn is None:
            return
        try:
            chips = self.capacity_fn()
        except Exception:
            log.debug("checkpoint-cadence: capacity read failed",
                      exc_info=True)
            return
        with self._lock:
            if chips is None:
                self._capacity_shrinking = False
            elif (self._last_capacity is not None
                  and chips < self._last_capacity):
                self._capacity_shrinking = True
            elif (self._last_capacity is None
                  or chips >= self._last_capacity):
                self._capacity_shrinking = False
            self._last_capacity = chips
        self._update_edge(capacity=chips)

    def _update_edge(self, **detail) -> None:
        """Emit tightened/restored exactly on the edges of the folded
        signal; the guard bounds the tighten rate (restores are never
        suppressed — the loop must be able to relax)."""
        with self._lock:
            tight = bool(self._firing) or self._capacity_shrinking
            if tight == self._tight:
                return
            self._tight = tight
        if tight:
            if self.guard.allow("tighten"):
                self.record("tightened", factor=self.tighten_factor,
                            **detail)
        else:
            self.record("restored", factor=1.0, **detail)

    def factor(self) -> float:
        """The save-interval multiplier the training loop applies —
        the shape ``run_with_checkpointing(cadence_signal=...)``
        expects (a zero-arg callable returning a float in (0, 1])."""
        with self._lock:
            return self.tighten_factor if self._tight else 1.0

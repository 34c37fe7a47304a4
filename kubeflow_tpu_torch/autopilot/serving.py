"""Serving-tier actuator: admission shedding while the SLOs burn.

A copy of ``kubeflow_tpu/autopilot/serving.py``'s
:class:`GatewayAdmissionActuator`, which lives in the gateway process
and rides the TTFT/ITL burn-rate edges: while the burn is critical the
engine's admission tightens (``max_pending`` cut, so 429s come earlier;
``prefill_per_cycle`` narrowed to 1, so decode cycles stop paying for
extra prefills mid-incident); when the last watched alert clears, the
configured values are restored. The reference's
``InferenceScaleActuator`` patches InferenceServices through the
Kubernetes API and belongs to a later slice (ROADMAP A5).
"""

from __future__ import annotations

import logging
import threading

from kubeflow_tpu_torch.autopilot.core import ActuationGuard, Actuator
from kubeflow_tpu_torch.obs.alerts import FIRING

log = logging.getLogger(__name__)


class GatewayAdmissionActuator(Actuator):
    """Tighten gateway admission while TTFT/ITL burn is critical.

    Edge-driven off the alert state machine, so the hysteresis is the
    alert's own ``for_s``/``clear_s`` — a flapping SLI is debounced
    before this actuator ever sees an edge, and the guard bounds the
    tighten rate on top. Restores are deliberately NOT rate-limited:
    returning the engine to its configured state must never be blocked
    behind a guard interval (a suppressed restore would strand the
    gateway shedding after the incident cleared)."""

    name = "gateway-admission"

    def __init__(self, engine,
                 objectives=("inference-ttft", "inference-itl"),
                 shed_factor: int = 4,
                 guard: ActuationGuard | None = None):
        super().__init__(guard=guard)
        self.engine = engine
        self.objectives = frozenset(objectives)
        self.shed_factor = max(2, int(shed_factor))
        self._lock = threading.Lock()
        self._firing: set[tuple[str, str]] = set()
        # None = running at configured values; else the values to
        # restore when the last watched alert clears.
        self._saved: dict | None = None

    @property
    def tightened(self) -> bool:
        with self._lock:
            return self._saved is not None

    def on_transition(self, transition: dict) -> None:
        if transition.get("slo") not in self.objectives:
            return
        key = (transition["slo"], transition["speed"])
        with self._lock:
            if (transition.get("to") == FIRING
                    and transition.get("severity") == "critical"):
                self._firing.add(key)
            elif transition.get("to") in ("resolved", "inactive"):
                self._firing.discard(key)
                if not self._firing and self._saved is not None:
                    self._restore_locked(transition)
                    return
            # The guard key is per alert: a suppressed tighten for one
            # flapping alert must not discard tightening for a LATER
            # incident on a different objective/speed. A still-firing
            # edge (e.g. the slow pair joining) also retries here.
            if (self._firing and self._saved is None
                    and self.guard.allow(f"tighten:{key[0]}/{key[1]}")):
                self._tighten_locked(transition)

    def on_tick(self, now: float | None = None) -> None:
        """Retry path: if a firing incident's tighten edge was guard-
        suppressed (or the actuator was registered mid-incident), the
        next tick picks it up — the guard bounds the rate, it must
        never drop the action for the incident's lifetime."""
        with self._lock:
            if not self._firing or self._saved is not None:
                return
            slo, speed = next(iter(self._firing))
            if self.guard.allow(f"tighten:{slo}/{speed}"):
                self._tighten_locked({"slo": slo, "speed": speed})

    def _tighten_locked(self, transition: dict) -> None:
        engine = self.engine
        saved = {
            "max_pending": engine.max_pending,
            "prefill_per_cycle": getattr(
                engine, "prefill_per_cycle", None),
        }
        # Earlier 429s: the admission inbox shrinks, so the shed
        # threshold the gateway already honours trips sooner.
        engine.max_pending = max(1,
                                 engine.max_pending // self.shed_factor)
        if saved["prefill_per_cycle"] is not None:
            # Narrower interleaving: one prefill per cycle keeps the
            # decode gap each in-flight stream sees minimal while the
            # ITL budget is burning.
            engine.prefill_per_cycle = 1
        self._saved = saved
        self.record(
            "tightened", slo=transition["slo"],
            speed=transition["speed"],
            max_pending=engine.max_pending,
            prefill_per_cycle=getattr(engine, "prefill_per_cycle",
                                      None),
        )

    def _restore_locked(self, transition: dict) -> None:
        engine = self.engine
        saved = self._saved
        engine.max_pending = saved["max_pending"]
        if saved["prefill_per_cycle"] is not None:
            engine.prefill_per_cycle = saved["prefill_per_cycle"]
        self._saved = None
        self.record(
            "restored", slo=transition["slo"],
            speed=transition["speed"],
            max_pending=engine.max_pending,
        )

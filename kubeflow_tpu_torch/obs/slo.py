"""Declarative SLOs and multi-window burn-rate evaluation (stdlib only).

A trimmed copy of ``kubeflow_tpu/obs/slo.py`` as far as the port's
gateway uses it: an :class:`Objective` promises a fraction of good
events, and :class:`BurnRateEvaluator` turns cumulative (good, total)
counts into windowed error rates and Google-SRE multi-window burn rates
(SRE workbook ch. 5): an objective with target T has an error budget
1 - T, the burn over a window is its error rate over the budget, and an
alert pairs a short and a long window that must both exceed the pair's
factor:

- **fast** pair: 5m + 1h windows at 14.4x (the page);
- **slow** pair: 30m + 6h windows at 6x (the ticket).

Everything takes an injectable clock; nothing here sleeps or threads.
State transitions live in :mod:`kubeflow_tpu_torch.obs.alerts`.

The gateway's TTFT and inter-token objectives read the port's own
histograms (``obs/exposition.py``, each backed by a
:class:`~kubeflow_tpu_torch.obs.metrics.BucketHistogram`) through
:func:`bucket_histogram_source`; the reference reads prometheus_client
histograms, which the port does not use. The reconcile, apiserver,
goodput and checkpoint objectives belong to the control plane and are
left out.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Callable

from kubeflow_tpu_torch.obs.envknob import env_number

log = logging.getLogger(__name__)

# Window pairs, Google-SRE style. ``for_s`` is how long the condition
# must hold before pending becomes firing; ``clear_s`` how long it must
# stay clear before a firing alert resolves (hysteresis both ways).
@dataclasses.dataclass(frozen=True)
class BurnPair:
    speed: str       # "fast" | "slow"
    short_s: float
    long_s: float
    factor: float
    for_s: float
    clear_s: float
    severity: str    # "critical" (page) | "warning" (ticket)


DEFAULT_PAIRS: tuple[BurnPair, ...] = (
    BurnPair("fast", 300.0, 3600.0, 14.4,
             for_s=60.0, clear_s=300.0, severity="critical"),
    BurnPair("slow", 1800.0, 21600.0, 6.0,
             for_s=900.0, clear_s=1800.0, severity="warning"),
)


@dataclasses.dataclass
class Objective:
    """One SLO: ``source()`` returns cumulative ``(good, total)`` event
    counts; the promise is good/total >= target over the SLO period.
    ``namespace`` scopes the objective for the fleet rollup (None =
    cluster-wide); ``threshold_s`` is informational for latency
    objectives (the "good" cut-off the source already encodes)."""

    name: str
    source: Callable[[], tuple[float, float]]
    target: float = 0.99
    description: str = ""
    namespace: str | None = None
    threshold_s: float | None = None

    @property
    def budget(self) -> float:
        return max(1.0 - float(self.target), 1e-9)


def tunable(slug: str, knob: str, default: float) -> float:
    """Env override for a default objective's knob:
    ``KFT_SLO_<SLUG>_<KNOB>`` (slug upper-cased, ``-`` -> ``_``) —
    e.g. ``KFT_SLO_RECONCILE_DURATION_TARGET=0.999``."""
    env = f"KFT_SLO_{slug.upper().replace('-', '_')}_{knob.upper()}"
    return env_number(env, default)


# ---------------------------------------------------------------------------
# sources: cumulative (good, total) adapters
# ---------------------------------------------------------------------------


def histogram_good_total(snapshot: dict, threshold_s: float) -> tuple[float, float]:
    """(good, total) from a BucketHistogram snapshot: good = cumulative
    count of the largest bucket bound <= threshold (the usual
    histogram-resolution cut)."""
    good = 0.0
    for le, cum in snapshot.get("buckets", []):
        if le == "+Inf":
            continue
        if float(le) <= threshold_s + 1e-12:
            good = float(cum)
        else:
            break
    return good, float(snapshot.get("count", 0))


def bucket_histogram_source(hist, threshold_s: float):
    """Source over anything with a BucketHistogram-shaped ``snapshot()``
    (or a zero-arg callable returning one, or None)."""

    def read() -> tuple[float, float]:
        h = hist() if callable(hist) else hist
        if h is None:
            return 0.0, 0.0
        return histogram_good_total(h.snapshot(), threshold_s)

    return read


# ---------------------------------------------------------------------------
# the gateway's objectives
# ---------------------------------------------------------------------------


def ttft_objective(metric, namespace: str | None = None) -> Objective:
    thr = tunable("inference-ttft", "threshold_s", 2.5)
    return Objective(
        name="inference-ttft",
        description=f"first token streamed within {thr:g}s",
        target=tunable("inference-ttft", "target", 0.99),
        threshold_s=thr,
        namespace=namespace,
        source=bucket_histogram_source(metric, thr),
    )


def itl_objective(metric, namespace: str | None = None) -> Objective:
    thr = tunable("inference-itl", "threshold_s", 0.25)
    return Objective(
        name="inference-itl",
        description=f"inter-token gaps stay under {thr:g}s",
        target=tunable("inference-itl", "target", 0.99),
        threshold_s=thr,
        namespace=namespace,
        source=bucket_histogram_source(metric, thr),
    )


# ---------------------------------------------------------------------------
# evaluator
# ---------------------------------------------------------------------------


class BurnRateEvaluator:
    """Samples cumulative (good, total) per objective on an injectable
    clock and computes windowed error/burn rates.

    A window's reference point is the newest sample at or before
    ``now - window``; before enough history exists, the oldest sample
    stands in (a *partial* window — deliberately conservative: a
    blackout 10 minutes into a fresh process must still trip the 1h
    window, not hide behind missing history). Counter resets (a source
    whose total went backwards — process restart) drop that
    objective's history rather than producing negative rates."""

    def __init__(
        self,
        pairs: tuple[BurnPair, ...] = DEFAULT_PAIRS,
        clock: Callable[[], float] = time.monotonic,
        max_samples: int = 8192,
    ):
        # max_samples must span the longest window at the caller's tick
        # cadence or the deque's own maxlen evicts the window reference
        # and the long window silently shrinks: the default 6h window
        # at SloEngine's 5s min-interval needs 4320 samples — 8192
        # leaves margin (the horizon trim keeps the deque near
        # window/interval + 1 anyway; the cap is a backstop).
        self.pairs = tuple(pairs)
        self.clock = clock
        self._max_samples = max(16, int(max_samples))
        self._objectives: dict[str, Objective] = {}
        self._samples: dict[str, deque] = {}

    # ---- registry --------------------------------------------------------
    def register(self, objective: Objective) -> Objective:
        if objective.name in self._objectives:
            raise ValueError(f"duplicate objective {objective.name!r}")
        self._objectives[objective.name] = objective
        self._samples[objective.name] = deque(maxlen=self._max_samples)
        return objective

    def objectives(self) -> list[Objective]:
        return list(self._objectives.values())

    # ---- sampling --------------------------------------------------------
    def sample(self, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        horizon = max(p.long_s for p in self.pairs) if self.pairs else 0.0
        for name, obj in self._objectives.items():
            try:
                good, total = obj.source()
            except Exception:
                # A broken source must not take down evaluation of the
                # others; the objective just stops accruing samples
                # (and its windows read as empty = healthy).
                log.debug("slo %s: source read failed", name,
                          exc_info=True)
                continue
            samples = self._samples[name]
            if samples and total < samples[-1][2]:
                samples.clear()  # counter reset (process restart)
            samples.append((now, float(good), float(total)))
            # Trim history beyond the longest window, keeping one
            # sample older than the horizon as the window reference.
            while (
                len(samples) > 2
                and samples[1][0] <= now - horizon
            ):
                samples.popleft()

    def _window(self, name: str, now: float, window_s: float) -> dict:
        samples = self._samples.get(name)
        if not samples:
            return {"events": 0.0, "error_rate": 0.0}
        cutoff = now - window_s
        ref = samples[0]
        for s in samples:
            if s[0] <= cutoff:
                ref = s
            else:
                break
        cur = samples[-1]
        d_total = cur[2] - ref[2]
        if d_total <= 0:
            return {"events": 0.0, "error_rate": 0.0}
        d_bad = max(d_total - (cur[1] - ref[1]), 0.0)
        return {
            "events": d_total,
            "error_rate": min(d_bad / d_total, 1.0),
        }

    def evaluate(self, now: float | None = None) -> list[dict]:
        """One row per objective: windowed error/burn rates and the
        per-pair violation verdict (burn >= factor on BOTH windows)."""
        now = self.clock() if now is None else now
        rows = []
        for name, obj in self._objectives.items():
            windows = {}
            for pair in self.pairs:
                short = self._window(name, now, pair.short_s)
                long_ = self._window(name, now, pair.long_s)
                short_burn = short["error_rate"] / obj.budget
                long_burn = long_["error_rate"] / obj.budget
                windows[pair.speed] = {
                    "short_s": pair.short_s,
                    "long_s": pair.long_s,
                    "factor": pair.factor,
                    "severity": pair.severity,
                    "for_s": pair.for_s,
                    "clear_s": pair.clear_s,
                    "short_rate": short["error_rate"],
                    "long_rate": long_["error_rate"],
                    "short_burn": short_burn,
                    "long_burn": long_burn,
                    "burn": min(short_burn, long_burn),
                    "violated": (
                        short_burn >= pair.factor
                        and long_burn >= pair.factor
                        and short["events"] > 0
                    ),
                }
            rows.append({
                "slo": name,
                "description": obj.description,
                "target": obj.target,
                "threshold_s": obj.threshold_s,
                "namespace": obj.namespace,
                "windows": windows,
            })
        return rows

    def tick(self, now: float | None = None) -> list[dict]:
        now = self.clock() if now is None else now
        self.sample(now)
        return self.evaluate(now)

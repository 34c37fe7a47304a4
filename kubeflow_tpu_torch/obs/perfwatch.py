"""Perf observatory: noise-banded measurement, anchors, verdicts.

The counterpart of ``kubeflow_tpu/obs/perfwatch.py`` for the port's
bench (``kubeflow_tpu_torch/bench.py``): the same record schema, band
math, verdict engine and ledger, so records of either package validate
in the other's :func:`validate_record`.

- **Multi-trial protocol**: :func:`timed_trials` / :class:`Measurement`:
  warm-up runs discarded, N timed trials, the nearest-rank median
  (:class:`PhaseDigest`'s percentile) and a MAD-derived noise band;
  trials farther than ``reject`` scaled MADs from the median are
  dropped and reported.
- **Host-noise sentinel**: :func:`host_noise_sentinel` grades the host
  ``quiet``/``noisy``/``loud`` from timer jitter, sleep overshoot and
  load; the grade sets the verdict's tolerance floor.
- **Provenance**: :func:`provenance` records the torch and CUDA
  versions, the platform (``"gpu"`` or ``"cpu"``) and the card's name,
  the git revision and the ``KFT_DECODE_*`` knobs in effect.
  :data:`COMPARABILITY_FIELDS` are ``platform``, ``device``, ``torch``
  and ``cuda``: a port record judged against an anchor the JAX package
  pinned on a TPU (``PERF_ANCHORS.json``, whose provenance names jax)
  reads ``incomparable``, never ``regressed`` or ``improved``.
- **Anchor registry** (:func:`load_anchors` / :func:`pin_anchors`),
  **verdict engine** (:func:`classify` / :func:`judge_records`) and
  **trajectory ledger** (:func:`append_ledger`, :func:`render_trend`),
  as the reference's.

Unlike the reference's, no path has a default: the repo's
``PERF_ANCHORS.json`` and ``PERF_TRAJECTORY.jsonl`` hold the JAX
package's TPU rounds, and the port's CLI
(``python -m kubeflow_tpu_torch.obs.perfwatch``) writes only where it is
told to.

Stdlib and the port's obs primitives only; torch is read from
``sys.modules``, so a process that never imported it pays nothing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Callable, Iterable

from kubeflow_tpu_torch.obs.profile import PhaseDigest

SCHEMA = "kft.perfwatch/v1"
ANCHORS_SCHEMA = "kft.perf-anchors/v1"

# MAD -> sigma-equivalent scale for normally distributed noise; the
# band half-width is MAD_SIGMA * MAD so "one band" reads like one
# standard deviation of a robust estimator, not an outlier-dragged one.
MAD_SIGMA = 1.4826

# Verdict tolerance floor per host-noise grade: even a zero-MAD trial
# set (3 identical readings) cannot honestly claim sub-percent
# resolution, and a loud host cannot claim much at all.
BAND_FLOORS = {"quiet": 0.02, "noisy": 0.05, "loud": 0.10}

# Dispatch-configuration env knobs recorded in provenance: these
# change WHICH kernel path a decode section measures, so two rounds
# differing on any of them are not the same experiment.
PROVENANCE_ENV_PREFIXES = ("KFT_DECODE_",)
PROVENANCE_ENV_EXTRA = ("KFT_BENCH_PRESET", "KFT_BENCH_DECODE_PATH")

GRADES = ("quiet", "noisy", "loud")


# ---------------------------------------------------------------------------
# percentile / band math (PhaseDigest's nearest-rank, reused verbatim)
# ---------------------------------------------------------------------------


def nearest_rank(values: Iterable[float], q: float) -> float:
    """Nearest-rank percentile via :class:`PhaseDigest` — the same
    exact, hand-computable math the profiler digests use (rank
    ``max(1, ceil(q*n))`` over the sorted values)."""
    values = list(values)
    if not values:
        return 0.0
    digest = PhaseDigest(window=len(values))
    for value in values:
        digest.observe(value)
    return digest.percentile(q)


def median_mad(values: Iterable[float]) -> tuple[float, float]:
    """(nearest-rank median, nearest-rank MAD). MAD — the median of
    absolute deviations from the median — is the robust spread
    estimator: one straggler trial moves it far less than a stddev."""
    values = list(values)
    med = nearest_rank(values, 0.5)
    mad = nearest_rank((abs(v - med) for v in values), 0.5)
    return med, mad


def noise_band(values: Iterable[float],
               floor: float | None = None) -> dict:
    """The banded summary of one trial set: median, MAD, relative
    half-width ``rel`` (``MAD_SIGMA * mad / median``, floored at
    ``floor`` when given) and the absolute ``lo``/``hi`` edges."""
    values = list(values)
    med, mad = median_mad(values)
    rel = (MAD_SIGMA * mad / med) if med > 0 else 0.0
    if floor is not None:
        rel = max(rel, float(floor))
    return {
        "n": len(values),
        "median": round(med, 6),
        "mad": round(mad, 6),
        "rel": round(rel, 6),
        "lo": round(med * (1.0 - rel), 6),
        "hi": round(med * (1.0 + rel), 6),
    }


def band_floor_for(grade: str | None) -> float:
    """The verdict tolerance floor this noise grade earns (unknown
    grades read as loud: no grade, no benefit of the doubt)."""
    return BAND_FLOORS.get(grade or "", BAND_FLOORS["loud"])


# ---------------------------------------------------------------------------
# the multi-trial measurement protocol
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Measurement:
    """One section's multi-trial measurement: kept trial values (in
    measurement order), rejected outliers, and the band over the kept
    set. ``median`` is the headline value."""

    values: list[float]
    rejected: list[float]
    median: float
    band: dict
    # Compact per-phase digests (dispatch/sync) when the trials ran
    # under a PhaseProfiler activation (bench KFT_BENCH_TELEMETRY=1).
    phases: dict | None = None

    @classmethod
    def from_values(cls, values: Iterable[float], *,
                    reject: float = 4.0,
                    band_floor: float | None = None) -> "Measurement":
        """Band a raw trial set. Outlier rejection: with >= 4 trials
        (below that every value counts), trials farther than
        ``reject`` scaled-MADs from the median are dropped and the
        band recomputed over the survivors; a degenerate MAD of zero
        rejects nothing (identical trials have no outliers)."""
        values = [float(v) for v in values]
        if not values:
            raise ValueError("a measurement needs at least one trial")
        kept, rejected = values, []
        if len(values) >= 4:
            med, mad = median_mad(values)
            spread = MAD_SIGMA * mad
            if spread > 0:
                kept = [v for v in values
                        if abs(v - med) <= reject * spread]
                rejected = [v for v in values
                            if abs(v - med) > reject * spread]
                if not kept:  # pathological set: keep everything
                    kept, rejected = values, []
        band = noise_band(kept, floor=band_floor)
        return cls(kept, rejected, band["median"], band)

    def as_rate(self, work: float) -> "Measurement":
        """The same trials re-expressed as ``work / seconds`` (trials
        are usually timed in seconds; records usually report rates).
        Outliers were already rejected on the time axis."""
        rate = Measurement.from_values(
            [work / v for v in self.values if v > 0], reject=float("inf")
        )
        rate.phases = self.phases
        return rate

    def to_dict(self, ndigits: int = 6) -> dict:
        out = {
            "trials": [round(v, ndigits) for v in self.values],
            "band": self.band,
        }
        if self.rejected:
            out["rejected_trials"] = [
                round(v, ndigits) for v in self.rejected
            ]
        if self.phases:
            out["phases"] = self.phases
        return out


def timed_trials(thunk: Callable[[], object], *, trials: int = 3,
                 warmup: int = 0,
                 clock: Callable[[], float] = time.perf_counter,
                 reject: float = 4.0,
                 band_floor: float | None = None) -> Measurement:
    """THE measurement protocol: run ``thunk`` ``warmup`` times
    untimed (compile, caches, first-touch stragglers), then ``trials``
    timed passes, and band the per-trial seconds. ``thunk`` must force
    its own completion (read a value of its result back to the host,
    or synchronize the card); the clock pair wraps exactly one trial."""
    for _ in range(max(0, int(warmup))):
        thunk()
    seconds = []
    for _trial in range(max(1, int(trials))):
        t0 = clock()
        thunk()
        seconds.append(clock() - t0)
    return Measurement.from_values(seconds, reject=reject,
                                   band_floor=band_floor)


# ---------------------------------------------------------------------------
# host-noise sentinel
# ---------------------------------------------------------------------------


def host_noise_sentinel(*, spin_samples: int = 4000, sleeps: int = 5,
                        sleep_s: float = 0.001,
                        clock: Callable[[], float] = time.perf_counter,
                        sleep: Callable[[float], None] = time.sleep,
                        loadavg: Callable[[], tuple] | None = None,
                        cpu_count: Callable[[], int | None] | None = None,
                        ) -> dict:
    """Measure the host, not the kernel: timer-tick jitter (p99 of
    successive ``clock()`` deltas over a tight spin), scheduler noise
    (p90 overshoot of a 1 ms sleep — a loaded box hands the CPU back
    late), and 1-minute load per core. The ``grade`` automates the
    quiet-host protocol BASELINE.md used to invoke by hand; every
    collaborator is injectable so tests grade deterministically."""
    deltas: list[float] = []
    prev = clock()
    for _ in range(max(2, int(spin_samples))):
        now = clock()
        if now > prev:
            deltas.append(now - prev)
        prev = now
    timer_p99 = nearest_rank(deltas, 0.99) if deltas else 0.0

    overshoots: list[float] = []
    for _ in range(max(0, int(sleeps))):
        t0 = clock()
        sleep(sleep_s)
        overshoots.append(max(clock() - t0 - sleep_s, 0.0))
    overshoot_p90 = nearest_rank(overshoots, 0.90) if overshoots else 0.0

    load1 = None
    try:
        load1 = float((loadavg or os.getloadavg)()[0])
    except (OSError, AttributeError):  # platform without loadavg
        load1 = None
    cpus = (cpu_count or os.cpu_count)() or 1
    load_ratio = (load1 / cpus) if load1 is not None else None

    if (load_ratio is not None and load_ratio >= 1.0) \
            or overshoot_p90 >= 0.020:
        grade = "loud"
    elif (load_ratio is not None and load_ratio >= 0.25) \
            or overshoot_p90 >= 0.002:
        grade = "noisy"
    else:
        grade = "quiet"
    return {
        "grade": grade,
        "timer_p99_s": round(timer_p99, 9),
        "sched_overshoot_p90_s": round(overshoot_p90, 6),
        "load1": round(load1, 3) if load1 is not None else None,
        "cpus": cpus,
        "load_ratio": round(load_ratio, 4)
        if load_ratio is not None else None,
    }


# ---------------------------------------------------------------------------
# provenance
# ---------------------------------------------------------------------------


def _git_rev(start: str | None = None) -> str | None:
    """Current git revision, stdlib-only: walk up to ``.git``, read
    HEAD, dereference one level. None outside a checkout."""
    directory = os.path.abspath(start or os.getcwd())
    while True:
        git_dir = os.path.join(directory, ".git")
        if os.path.isdir(git_dir):
            break
        parent = os.path.dirname(directory)
        if parent == directory:
            return None
        directory = parent
    try:
        with open(os.path.join(git_dir, "HEAD")) as fh:
            head = fh.read().strip()
        if head.startswith("ref:"):
            ref = head.split(None, 1)[1]
            ref_path = os.path.join(git_dir, *ref.split("/"))
            if os.path.exists(ref_path):
                with open(ref_path) as fh:
                    return fh.read().strip()
            packed = os.path.join(git_dir, "packed-refs")
            with open(packed) as fh:
                for line in fh:
                    if line.strip().endswith(ref):
                        return line.split()[0]
            return None
        return head
    except (OSError, IndexError):
        return None


def provenance(env: dict | None = None, device=None) -> dict:
    """The record's "what was measured under" block: the torch and CUDA
    versions, the platform (``"gpu"`` or ``"cpu"``) and device name of
    ``device`` (by default the card when there is one, else the CPU),
    the git revision, and every dispatch-relevant env knob in effect
    (``KFT_DECODE_*`` plus the explicit extras). torch is read from
    ``sys.modules`` only: a process that never imported it reports
    ``platform: None``."""
    environ = os.environ if env is None else env
    knobs = {
        key: environ[key]
        for key in sorted(environ)
        if key.startswith(PROVENANCE_ENV_PREFIXES)
        or key in PROVENANCE_ENV_EXTRA
    }
    out: dict = {
        "git_rev": _git_rev(),
        "python": ".".join(str(v) for v in sys.version_info[:3]),
        "torch": None,
        "cuda": None,
        "platform": None,
        "device": None,
        "env": knobs,
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        out["torch"] = getattr(torch, "__version__", None)
        out["cuda"] = getattr(getattr(torch, "version", None), "cuda", None)
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        device = torch.device(device)
        if device.type == "cuda":
            out["platform"] = "gpu"
            out["device"] = torch.cuda.get_device_name(device)
        else:
            out["platform"] = out["device"] = "cpu"
    return out


# Fields whose mismatch makes two rounds different experiments. The
# git rev is deliberately absent: code changes are exactly what a
# verdict is supposed to judge, not refuse to judge.
COMPARABILITY_FIELDS = ("platform", "device", "torch", "cuda")


def provenance_mismatches(measured: dict | None,
                          anchored: dict | None) -> list[str]:
    """Fields on which the two provenance blocks disagree — nonempty
    means 'incomparable', the verdict that tells an image bump or a
    flipped KFT_DECODE_* knob apart from a kernel regression."""
    a, b = measured or {}, anchored or {}
    mismatched = [
        field for field in COMPARABILITY_FIELDS
        if a.get(field) != b.get(field)
    ]
    env_a = a.get("env") or {}
    env_b = b.get("env") or {}
    for key in sorted(set(env_a) | set(env_b)):
        if env_a.get(key) != env_b.get(key):
            mismatched.append(f"env:{key}")
    return mismatched


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


def make_record(section: str, metric: str, unit: str,
                measurement: Measurement, *, noise: dict | None = None,
                prov: dict | None = None,
                extra: dict | None = None) -> dict:
    """One schema'd perfwatch record — the shape bench sections, the
    serve_qps gateway summary, and any future perf source share, so
    one verdict engine and one ledger serve them all."""
    record = dict(extra or {})
    record.update({
        "schema": SCHEMA,
        "section": section,
        "metric": metric,
        "unit": unit,
        # 6 digits, matching the band edges: coarser rounding can push
        # a seconds-scale value outside its own lo..hi band.
        "value": round(measurement.median, 6),
        **measurement.to_dict(),
        "noise": noise if noise is not None else host_noise_sentinel(),
        "provenance": prov if prov is not None else provenance(),
    })
    return record


def validate_record(record: object) -> list[str]:
    """Schema check; returns the list of problems (empty == valid).
    Extra keys are always fine — the schema is a floor, not a fence."""
    problems: list[str] = []
    if not isinstance(record, dict):
        return ["record is not an object"]

    def _number(value) -> bool:
        return isinstance(value, (int, float)) \
            and not isinstance(value, bool)

    if record.get("schema") != SCHEMA:
        problems.append(f"schema must be {SCHEMA!r}")
    for key in ("section", "metric", "unit"):
        if not (isinstance(record.get(key), str) and record.get(key)):
            problems.append(f"{key} must be a non-empty string")
    if not (_number(record.get("value")) and record.get("value", -1) >= 0):
        problems.append("value must be a non-negative number")
    trials = record.get("trials")
    if not (isinstance(trials, list) and trials
            and all(_number(t) for t in trials)):
        problems.append("trials must be a non-empty list of numbers")
    band = record.get("band")
    if not isinstance(band, dict):
        problems.append("band must be an object")
    else:
        for key in ("n", "median", "mad", "rel", "lo", "hi"):
            if not _number(band.get(key)):
                problems.append(f"band.{key} must be a number")
        if _number(band.get("lo")) and _number(band.get("hi")) \
                and band["lo"] > band["hi"]:
            problems.append("band.lo must not exceed band.hi")
    noise = record.get("noise")
    if not (isinstance(noise, dict) and noise.get("grade") in GRADES):
        problems.append(
            "noise.grade must be one of " + "/".join(GRADES)
        )
    prov = record.get("provenance")
    if not isinstance(prov, dict):
        problems.append("provenance must be an object")
    else:
        for key in ("git_rev", "platform", "env"):
            if key not in prov:
                problems.append(f"provenance.{key} missing")
    return problems


def records_from_full(doc: dict) -> list[dict]:
    """The judge's view of one bench full record: the primary-metric
    record plus every section in ``extra_metrics`` that carries a
    ``section`` name (error entries and pre-protocol records without
    one are skipped — nothing to band a verdict on)."""
    out = []
    for record in [doc] + list(doc.get("extra_metrics") or []):
        if record.get("metric") == "bench_extra_error":
            continue
        if record.get("section") and record.get("value") is not None:
            out.append(record)
    return out


# ---------------------------------------------------------------------------
# anchor registry
# ---------------------------------------------------------------------------


def _atomic_write_json(path: str, doc: dict) -> None:
    """tmp + ``os.replace``: the rename is the commit point, a crash
    mid-write never tears the artifact."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def load_anchors(path: str) -> dict:
    """The anchor registry document ({schema, round, anchors:{section:
    {value, unit, band_rel, noise_grade, pinned_round, provenance}}});
    an absent file is an empty registry."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        return {"schema": ANCHORS_SCHEMA, "round": None, "anchors": {}}
    if not isinstance(doc, dict) or not isinstance(
            doc.get("anchors"), dict):
        raise ValueError(
            f"anchor registry {path} is not a valid document"
        )
    return doc


def pin_anchors(records: list[dict], round_id: str, *,
                path: str,
                sections: list[str] | None = None) -> dict:
    """Re-pin anchors from measured records (all of them, or only the
    named ``sections``): value, band, noise grade and provenance land
    in the registry under ``pinned_round``; untouched sections keep
    their existing pins. Atomic write; returns the new document."""
    doc = load_anchors(path)
    doc["schema"] = ANCHORS_SCHEMA
    doc["round"] = round_id
    wanted = set(sections) if sections is not None else None
    pinned = 0
    for record in records:
        section = record.get("section")
        if not section or (wanted is not None and section not in wanted):
            continue
        band = record.get("band") or {}
        doc["anchors"][section] = {
            "value": record.get("value"),
            "unit": record.get("unit"),
            "band_rel": band.get("rel", 0.0),
            "noise_grade": (record.get("noise") or {}).get("grade"),
            "pinned_round": round_id,
            "provenance": record.get("provenance"),
        }
        pinned += 1
    if wanted is not None and pinned < len(wanted):
        missing = sorted(
            wanted - {r.get("section") for r in records}
        )
        raise ValueError(
            f"sections not present in the record: {', '.join(missing)}"
        )
    _atomic_write_json(path, doc)
    return doc


# ---------------------------------------------------------------------------
# verdict engine
# ---------------------------------------------------------------------------

IMPROVED = "improved"
REGRESSED = "regressed"
WITHIN_NOISE = "within-noise"
INCOMPARABLE = "incomparable"
NEW_SECTION = "new-section"
MISSING_SECTION = "missing-section"


@dataclasses.dataclass
class Verdict:
    section: str
    status: str
    value: float | None = None
    anchor: float | None = None
    ratio: float | None = None
    tolerance: float | None = None
    notes: str = ""

    def render(self) -> str:
        parts = [f"{self.section}: {self.status}"]
        if self.ratio is not None and self.tolerance is not None:
            parts.append(
                f"(x{self.ratio:.4f} vs anchor {self.anchor}, "
                f"tolerance ±{100 * self.tolerance:.1f}%)"
            )
        if self.notes:
            parts.append(f"— {self.notes}")
        return " ".join(parts)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def classify(record: dict, anchor: dict | None) -> Verdict:
    """One section against its banded anchor. The tolerance is the sum
    of the anchor's band, the measurement's band, and the noise-grade
    floor of the LOUDER of the two rounds — two honest bands plus a
    floor neither round can undercut. Provenance mismatch short-
    circuits to ``incomparable``: re-pin (legitimately) instead of
    arguing with a different experiment."""
    section = str(record.get("section") or record.get("metric") or "?")
    value = record.get("value")
    if anchor is None or anchor.get("value") in (None, 0):
        return Verdict(section, NEW_SECTION, value=value,
                       notes="no anchor pinned for this section")
    mismatched = provenance_mismatches(
        record.get("provenance"), anchor.get("provenance")
    )
    if mismatched:
        return Verdict(
            section, INCOMPARABLE, value=value,
            anchor=anchor.get("value"),
            notes="provenance mismatch on " + ", ".join(mismatched),
        )
    anchor_value = float(anchor["value"])
    measured_band = float((record.get("band") or {}).get("rel") or 0.0)
    anchor_band = float(anchor.get("band_rel") or 0.0)
    floor = max(
        band_floor_for((record.get("noise") or {}).get("grade")),
        band_floor_for(anchor.get("noise_grade")),
    )
    tolerance = anchor_band + measured_band + floor
    ratio = float(value) / anchor_value
    if ratio >= 1.0 + tolerance:
        status = IMPROVED
    elif ratio <= 1.0 - tolerance:
        status = REGRESSED
    else:
        status = WITHIN_NOISE
    return Verdict(section, status, value=value, anchor=anchor_value,
                   ratio=round(ratio, 6), tolerance=round(tolerance, 6))


def judge_records(records: list[dict], anchors_doc: dict,
                  sections: list[str] | None = None) -> list[Verdict]:
    """Every record against the registry, plus a ``missing-section``
    verdict for each anchored section the round failed to measure — a
    silently vanished section must not read as a green round."""
    anchors = anchors_doc.get("anchors") or {}
    wanted = set(sections) if sections is not None else None
    verdicts = []
    seen = set()
    for record in records:
        section = record.get("section")
        if not section or (wanted is not None and section not in wanted):
            continue
        seen.add(section)
        verdicts.append(classify(record, anchors.get(section)))
    for section in sorted(anchors):
        if section in seen or (wanted is not None
                               and section not in wanted):
            continue
        verdicts.append(Verdict(
            section, MISSING_SECTION,
            anchor=(anchors[section] or {}).get("value"),
            notes="anchored section absent from this round",
        ))
    return verdicts


def verdict_exit_code(verdicts: list[Verdict]) -> int:
    """Nonzero exactly when a section regressed — the gate contract.
    ``incomparable``/``missing-section`` inform loudly but do not
    gate (they have their own remedies: re-pin, or fix the section)."""
    return 1 if any(v.status == REGRESSED for v in verdicts) else 0


# ---------------------------------------------------------------------------
# trajectory ledger
# ---------------------------------------------------------------------------


def ledger_entry(round_id: str, section: str, value: float, *,
                 unit: str | None = None, vs: float | None = None,
                 band_rel: float | None = None,
                 noise_grade: str | None = None,
                 source: str | None = None) -> dict:
    entry: dict = {"round": round_id, "section": section,
                   "value": value}
    if unit is not None:
        entry["unit"] = unit
    if vs is not None:
        entry["vs"] = vs
    if band_rel is not None:
        entry["band_rel"] = band_rel
    if noise_grade is not None:
        entry["noise_grade"] = noise_grade
    if source is not None:
        entry["source"] = source
    return entry


def read_ledger(path: str) -> list[dict]:
    """Every well-formed line of the ledger, in file order (a torn or
    hand-mangled line is skipped, not fatal — the ledger is evidence,
    and partial evidence beats none)."""
    entries: list[dict] = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except ValueError:
                    continue
                if isinstance(entry, dict):
                    entries.append(entry)
    except FileNotFoundError:
        pass
    return entries


def append_ledger(path: str, entries: list[dict]) -> int:
    """Append entries not already present (identity: round + section +
    source), atomically: the whole new file is written to a tmp name
    and ``os.replace``d over the old, so a
    crash mid-append can never leave a half-written line for
    ``read_ledger`` to skip silently forever. Returns how many
    entries were actually appended."""
    existing = read_ledger(path)
    present = {
        (e.get("round"), e.get("section"), e.get("source"))
        for e in existing
    }
    fresh = [
        e for e in entries
        if (e.get("round"), e.get("section"), e.get("source"))
        not in present
    ]
    if not fresh:
        return 0
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        for entry in existing + fresh:
            fh.write(json.dumps(entry, sort_keys=True) + "\n")
    os.replace(tmp, path)
    return len(fresh)


def _short_section(metric_name: str) -> str:
    """The compact section key bench.py's compact_record uses
    ("lm_decode_tokens_per_sec_per_chip[b1-p8k]" -> "decode[b1-p8k]");
    kept in lockstep so ledger rows join across round formats."""
    return (metric_name.replace("lm_", "", 1)
            .replace("_tokens_per_sec_per_chip", ""))


def entries_from_bench_round(doc: dict, round_id: str,
                              source: str | None = None) -> list[dict]:
    """Ledger entries from a committed BENCH_rNN.json capture
    (the ``parsed`` compact line: headline + per-section {v, vs})."""
    parsed = doc.get("parsed") or {}
    entries: list[dict] = []
    if parsed.get("value") is not None:
        entries.append(ledger_entry(
            round_id, "resnet", parsed["value"],
            unit=parsed.get("unit"), vs=parsed.get("vs_baseline"),
            source=source,
        ))
    for section, row in (parsed.get("sections") or {}).items():
        if not isinstance(row, dict) or row.get("v") is None:
            continue
        entries.append(ledger_entry(
            round_id, section, row["v"], vs=row.get("vs"),
            source=source,
        ))
    return entries


def entries_from_full_record(doc: dict, round_id: str,
                             source: str | None = None) -> list[dict]:
    """Ledger entries from a protocol-era full bench record — these
    carry bands and the round's noise grade alongside value/vs."""
    entries: list[dict] = []
    for record in records_from_full(doc):
        section = record["section"]
        if section != "resnet":
            section = _short_section(section) \
                if section.startswith("lm_") else section
        entries.append(ledger_entry(
            round_id, section, record["value"],
            unit=record.get("unit"), vs=record.get("vs_baseline"),
            band_rel=(record.get("band") or {}).get("rel"),
            noise_grade=(record.get("noise") or {}).get("grade"),
            source=source,
        ))
    return entries


def render_trend(entries: list[dict]) -> str:
    """The trajectory as one table: rows = sections (first-seen
    order), columns = rounds (sorted), cell = value with the
    vs-baseline ratio when recorded. BENCH_r01…rNN as one readable
    time series instead of N disconnected files."""
    if not entries:
        return "(empty trajectory ledger)"
    rounds: list[str] = []
    sections: list[str] = []
    cells: dict[tuple[str, str], str] = {}
    for entry in entries:
        round_id = str(entry.get("round"))
        section = str(entry.get("section"))
        if round_id not in rounds:
            rounds.append(round_id)
        if section not in sections:
            sections.append(section)
        value = entry.get("value")
        cell = f"{value:g}" if isinstance(value, (int, float)) else "?"
        if entry.get("vs") is not None:
            cell += f" ({entry['vs']:.2f}x)"
        cells[(section, round_id)] = cell
    rounds.sort()
    width = max(len(s) for s in sections) + 2
    col_widths = {
        r: max(len(r), *(len(cells.get((s, r), "-")) for s in sections))
        + 2
        for r in rounds
    }
    lines = ["".join(["section".ljust(width)]
                     + [r.rjust(col_widths[r]) for r in rounds])]
    for section in sections:
        lines.append("".join(
            [section.ljust(width)]
            + [cells.get((section, r), "-").rjust(col_widths[r])
               for r in rounds]
        ))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _round_id_for(path: str) -> str:
    """BENCH_r04.json -> r04 (the backfill default)."""
    base = os.path.basename(path)
    stem = base.split(".")[0]
    tail = stem.rsplit("_", 1)[-1]
    return tail if tail.startswith("r") else stem


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m kubeflow_tpu_torch.obs.perfwatch",
        description=__doc__.splitlines()[0],
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("noise", help="measure + print the host-noise "
                                     "sentinel document")

    p = sub.add_parser("verdict", help="judge a bench record against "
                                       "the anchor registry; exit 1 "
                                       "on any regression")
    p.add_argument("--record", required=True,
                   help="a full bench record (one JSON document)")
    p.add_argument("--anchors", required=True)
    p.add_argument("--sections", nargs="*", default=None)
    p.add_argument("--json", action="store_true",
                   help="machine-readable verdicts")

    p = sub.add_parser("pin", help="re-pin anchors from a measured "
                                   "record (value + band + provenance)")
    p.add_argument("--record", required=True)
    p.add_argument("--round", required=True, dest="round_id")
    p.add_argument("--anchors", required=True)
    p.add_argument("--sections", nargs="*", default=None)

    p = sub.add_parser("ingest", help="append a protocol-era full "
                                      "record to the trajectory ledger")
    p.add_argument("--record", required=True)
    p.add_argument("--round", required=True, dest="round_id")
    p.add_argument("--ledger", required=True)
    p.add_argument("--source", default=None)

    p = sub.add_parser("backfill", help="rebuild ledger entries from "
                                        "committed BENCH_rNN.json "
                                        "captures")
    p.add_argument("rounds", nargs="+",
                   help="BENCH_rNN.json files (round id from the name)")
    p.add_argument("--ledger", required=True)

    p = sub.add_parser("report", help="render the trajectory ledger "
                                      "as one trend table")
    p.add_argument("--ledger", required=True)

    args = parser.parse_args(argv)

    if args.command == "noise":
        print(json.dumps(host_noise_sentinel(), indent=1))
        return 0

    if args.command == "verdict":
        records = records_from_full(_load_json(args.record))
        verdicts = judge_records(records, load_anchors(args.anchors),
                                 sections=args.sections)
        if args.json:
            print(json.dumps([v.to_dict() for v in verdicts], indent=1))
        else:
            for verdict in verdicts:
                print(verdict.render())
            counts: dict[str, int] = {}
            for verdict in verdicts:
                counts[verdict.status] = counts.get(verdict.status, 0) + 1
            print("summary: " + ", ".join(
                f"{counts[s]} {s}" for s in sorted(counts)
            ))
        return verdict_exit_code(verdicts)

    if args.command == "pin":
        records = records_from_full(_load_json(args.record))
        doc = pin_anchors(records, args.round_id, path=args.anchors,
                          sections=args.sections)
        print(f"pinned {len(doc['anchors'])} anchor(s) "
              f"(round {args.round_id}) -> {args.anchors}")
        return 0

    if args.command == "ingest":
        entries = entries_from_full_record(
            _load_json(args.record), args.round_id, source=args.source
        )
        added = append_ledger(args.ledger, entries)
        print(f"appended {added} entr(ies) -> {args.ledger}")
        return 0

    if args.command == "backfill":
        added = 0
        for path in args.rounds:
            doc = _load_json(path)
            added += append_ledger(args.ledger, entries_from_bench_round(
                doc, _round_id_for(path), source=os.path.basename(path)
            ))
        print(f"appended {added} entr(ies) -> {args.ledger}")
        return 0

    if args.command == "report":
        print(render_trend(read_ledger(args.ledger)))
        return 0

    parser.error(f"unknown command {args.command!r}")
    return 2


if __name__ == "__main__":
    try:
        rc = main()
    except BrokenPipeError:
        # `perfwatch report | head` closing the pipe is not an error;
        # point stdout at devnull so the interpreter's exit flush
        # doesn't raise a second time.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        rc = 0
    raise SystemExit(rc)

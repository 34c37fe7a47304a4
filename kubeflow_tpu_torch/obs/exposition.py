"""Prometheus exposition for the port, without ``prometheus_client``.

The reference gateway renders ``/metrics`` with ``prometheus_client``;
the port does not depend on it (a CUDA serving image need not carry it),
and this module gives the port the same surface in the standard
library. It holds:

- a :class:`Registry` of collectors, each yielding metric families;
- registry-owned metrics :class:`Counter`, :class:`Gauge` (read
  through ``set_function``) and :class:`Histogram` (with OpenMetrics
  exemplars), labelled or not, each child stamped with its creation
  time as ``prometheus_client`` does;
- :class:`CounterFamily`, :class:`GaugeFamily` and
  :class:`HistogramFamily` for custom collectors that render state kept
  elsewhere at scrape time (the engine's counters and histograms);
- :func:`render_text` (Prometheus text 0.0.4) and
  :func:`render_openmetrics` (OpenMetrics 1.0, the only format that
  carries exemplars), sample for sample as ``prometheus_client`` 0.2x
  renders the same registry: counters gain ``_total`` and ``_created``,
  histograms ``_bucket``/``_count``/``_sum``/``_created``; labels sorted;
  floats in Go's notation;
- :func:`parse_text`, a reader of either format for callers that must
  check a scrape without ``prometheus_client`` (the card smoke).

Metric names, help strings, label names and bucket bounds are the
callers'; the gateway keeps the reference's.
"""

from __future__ import annotations

import dataclasses
import math
import re
import threading
import time
from typing import Callable, Iterable

from kubeflow_tpu_torch.obs.metrics import LATENCY_BUCKETS, BucketHistogram

CONTENT_TYPE_TEXT = "text/plain; version=0.0.4"
CONTENT_TYPE_OPENMETRICS = ("application/openmetrics-text; version=1.0.0; "
                            "charset=utf-8")


@dataclasses.dataclass
class Sample:
    name: str
    labels: dict
    value: float
    exemplar: dict | None = None   # {"trace_id", "value", "ts"}


class Family:
    """One metric family: name (without ``_total`` for a counter), help,
    type and its samples."""

    def __init__(self, name: str, documentation: str, typ: str,
                 labels: Iterable[str] = ()):
        self.name = name
        self.documentation = documentation
        self.type = typ
        self.labelnames = tuple(labels)
        self.samples: list[Sample] = []

    def _labels(self, values) -> dict:
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: labels {self.labelnames}, got "
                             f"values {tuple(values)}")
        return dict(zip(self.labelnames, map(str, values)))


class CounterFamily(Family):
    def __init__(self, name: str, documentation: str, value=None,
                 labels: Iterable[str] = ()):
        super().__init__(name.removesuffix("_total"), documentation,
                         "counter", labels)
        if value is not None:
            self.add_metric([], value)

    def add_metric(self, values, value, created: float | None = None):
        labels = self._labels(values)
        self.samples.append(Sample(f"{self.name}_total", labels, value))
        if created is not None:
            self.samples.append(Sample(f"{self.name}_created", labels,
                                       created))


class GaugeFamily(Family):
    def __init__(self, name: str, documentation: str,
                 labels: Iterable[str] = ()):
        super().__init__(name, documentation, "gauge", labels)

    def add_metric(self, values, value):
        self.samples.append(Sample(self.name, self._labels(values), value))


class HistogramFamily(Family):
    def __init__(self, name: str, documentation: str,
                 labels: Iterable[str] = ()):
        super().__init__(name, documentation, "histogram", labels)

    def add_metric(self, values, buckets, sum_value,
                   created: float | None = None,
                   exemplars: dict | None = None):
        """``buckets``: cumulative [(upper bound string, count), ...,
        ("+Inf", total)], a :class:`BucketHistogram` snapshot's;
        ``exemplars``: bound string -> exemplar dict."""
        labels = self._labels(values)
        for le, count in buckets:
            self.samples.append(Sample(
                f"{self.name}_bucket", {**labels, "le": le}, count,
                (exemplars or {}).get(le)))
        self.samples.append(Sample(f"{self.name}_count", labels,
                                   buckets[-1][1]))
        self.samples.append(Sample(f"{self.name}_sum", labels, sum_value))
        if created is not None:
            self.samples.append(Sample(f"{self.name}_created", labels,
                                       created))


class Registry:
    """Collectors in registration order; each has ``collect()`` yielding
    :class:`Family` objects."""

    def __init__(self):
        self._lock = threading.Lock()
        # One entry per registered collector, fixed at wiring time.
        self._collectors: list = []  # analysis: allow[py-unbounded-deque]

    def register(self, collector) -> None:
        with self._lock:
            self._collectors.append(collector)

    def collect(self):
        with self._lock:
            collectors = list(self._collectors)
        for collector in collectors:
            yield from collector.collect()


# ------------------------------------------------------ owned metrics


class _Metric:
    """A registry-owned metric: children per label values, created at
    first ``labels()`` (an unlabelled metric has its one child from the
    start)."""

    def __init__(self, name: str, documentation: str,
                 labelnames: Iterable[str] = (), registry=None):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()
        if registry is not None:
            registry.register(self)

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values):
        if len(values) != len(self.labelnames) or not self.labelnames:
            raise ValueError(f"{self.name}: labels {self.labelnames}, got "
                             f"{values}")
        key = tuple(map(str, values))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def _unlabelled(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labelled; call labels() first")
        return self._children[()]

    def _items(self) -> list[tuple[tuple, object]]:
        with self._lock:
            return list(self._children.items())


class _CounterChild:
    def __init__(self):
        self.created = time.time()
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += float(amount)


class Counter(_Metric):
    def __init__(self, name: str, documentation: str,
                 labelnames: Iterable[str] = (), registry=None):
        super().__init__(name.removesuffix("_total"), documentation,
                         labelnames, registry)

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._unlabelled().inc(amount)

    def collect(self):
        fam = CounterFamily(self.name, self.documentation,
                            labels=self.labelnames)
        for values, child in self._items():
            fam.add_metric(values, child.value, created=child.created)
        yield fam


class _GaugeChild:
    def __init__(self):
        self.fn: Callable[[], float] = lambda: 0.0

    def get(self) -> float:
        return float(self.fn())

    def set(self, value: float) -> None:
        value = float(value)
        self.fn = lambda: value


class Gauge(_Metric):
    """A gauge read from a function at every scrape (the gateway's queue
    depth) or holding the last value ``set`` (step telemetry)."""

    def _new_child(self):
        return _GaugeChild()

    def set_function(self, fn: Callable[[], float]) -> None:
        self._unlabelled().fn = fn

    def set(self, value: float) -> None:
        self._unlabelled().set(value)

    def collect(self):
        fam = GaugeFamily(self.name, self.documentation,
                          labels=self.labelnames)
        for values, child in self._items():
            fam.add_metric(values, child.get())
        yield fam


class _HistogramChild(BucketHistogram):
    def __init__(self, buckets):
        super().__init__(buckets, exemplars=True)
        self.created = time.time()

    def observe(self, value: float, exemplar: dict | None = None) -> None:
        """``exemplar``: {"trace_id": ...} for the OpenMetrics exemplar of
        the bucket ``value`` lands in (else the current sampled span's)."""
        super().observe(value, (exemplar or {}).get("trace_id"))


class Histogram(_Metric):
    def __init__(self, name: str, documentation: str,
                 labelnames: Iterable[str] = (), registry=None,
                 buckets: tuple[float, ...] = LATENCY_BUCKETS):
        self.buckets = tuple(buckets)
        super().__init__(name, documentation, labelnames, registry)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float, exemplar: dict | None = None) -> None:
        self._unlabelled().observe(value, exemplar)

    def snapshot(self) -> dict:
        """The unlabelled histogram's BucketHistogram snapshot (what the
        SLO sources read)."""
        return self._unlabelled().snapshot()

    def collect(self):
        fam = HistogramFamily(self.name, self.documentation,
                              labels=self.labelnames)
        for values, child in self._items():
            snap = child.snapshot()
            fam.add_metric(values, snap["buckets"], snap["sum"],
                           created=child.created,
                           exemplars=snap.get("exemplars"))
        yield fam


# ---------------------------------------------------------- rendering


def go_float(value) -> str:
    """A float as Go (and so Prometheus) writes it: +Inf/-Inf/NaN, and
    an exponent once the integer part passes six digits."""
    d = float(value)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_value(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r"\""))


def _labelstr(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{_escape_value(v)}"'
                    for k, v in sorted(labels.items()))
    return "{" + body + "}"


def _line(sample: Sample, exemplar: bool = False) -> str:
    text = f"{sample.name}{_labelstr(sample.labels)} {go_float(sample.value)}"
    if exemplar and sample.exemplar is not None:
        ex = sample.exemplar
        text += (f' # {{trace_id="{_escape_value(ex["trace_id"])}"}} '
                 f"{go_float(ex['value'])} {ex['ts']}")
    return text + "\n"


def render_text(registry: Registry) -> bytes:
    """Prometheus text format 0.0.4: a counter family is written under
    ``<name>_total``, and every ``_created`` sample moves to a gauge
    family of its own after its family's samples."""
    out: list[str] = []
    for fam in registry.collect():
        name = f"{fam.name}_total" if fam.type == "counter" else fam.name
        doc = fam.documentation.replace("\\", r"\\").replace("\n", r"\n")
        out.append(f"# HELP {name} {doc}\n# TYPE {name} {fam.type}\n")
        created = []
        for sample in fam.samples:
            if sample.name == f"{fam.name}_created":
                created.append(_line(sample))
            else:
                out.append(_line(sample))
        if created:
            out.append(f"# HELP {fam.name}_created {doc}\n"
                       f"# TYPE {fam.name}_created gauge\n")
            out.extend(created)
    return "".join(out).encode()


def render_openmetrics(registry: Registry) -> bytes:
    """OpenMetrics 1.0 text: families under their own names, exemplars on
    the bucket lines that hold one, ``# EOF`` last."""
    out: list[str] = []
    for fam in registry.collect():
        doc = _escape_value(fam.documentation)
        out.append(f"# HELP {fam.name} {doc}\n# TYPE {fam.name} {fam.type}\n")
        out.extend(_line(sample, exemplar=True) for sample in fam.samples)
    out.append("# EOF\n")
    return "".join(out).encode()


# ------------------------------------------------------------ reading

_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*?\})?\s+(\S+)")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(value: str) -> str:
    return re.sub(r"\\(.)", lambda m: {"n": "\n"}.get(m.group(1),
                                                       m.group(1)), value)


def parse_text(text: str) -> dict[str, dict]:
    """Families of a 0.0.4 or OpenMetrics scrape: ``{name: {"type",
    "help", "samples": [(sample name, labels, value), ...]}}``, keyed by
    the name on the ``# TYPE`` line; each sample belongs to the family
    declared last before it. Exemplars are dropped."""
    families: dict[str, dict] = {}
    current: dict | None = None
    helps: dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line == "# EOF":
            continue
        if line.startswith("# HELP "):
            name, _, doc = line[len("# HELP "):].partition(" ")
            helps[name] = doc
            continue
        if line.startswith("# TYPE "):
            name, _, typ = line[len("# TYPE "):].partition(" ")
            current = families.setdefault(
                name, {"type": typ, "help": helps.get(name, ""),
                       "samples": []})
            continue
        if line.startswith("#"):
            continue
        match = _SAMPLE_RE.match(line.split(" # ", 1)[0])
        if match is None or current is None:
            raise ValueError(f"unparsable exposition line: {raw!r}")
        name, labelstr, value = match.groups()
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(labelstr or "")}
        current["samples"].append((name, labels, float(value)))
    return families


def sample_value(families: dict[str, dict], name: str,
                 labels: dict | None = None) -> float | None:
    """The value of the first sample called ``name`` whose labels include
    ``labels``, or None."""
    want = labels or {}
    for fam in families.values():
        for sample_name, sample_labels, value in fam["samples"]:
            if sample_name == name and all(sample_labels.get(k) == v
                                           for k, v in want.items()):
                return value
    return None

"""Discovery by name, the run's context, the import check and the
result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
The harness loads ``configs/<config>.json`` and
``traffic/<traffic>.json``, imports ``drivers/<driver>.py`` for the
mix's ``driver``, reads the cell's limits from
``workloads/<cell>.json``, and after a traced run hands the driver's
:class:`Reading` to ``metrics/<metric>.py`` for every per-layer metric
the cell reports. None of these files is edited to add another: a new
cell, mix or metric is a new file and a new entry.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
PROGRAM = "kubeflow_tpu_torch"
# Top-level module names no run may hold once its window has closed:
# the JAX package and what it runs on.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "kubeflow_tpu"})


def process_start() -> float:
    """``time.perf_counter()`` at this process's start, from the
    kernel's record of when it began (``/proc/self/stat``)."""
    now = time.perf_counter()
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    started_ticks = int(fields[19])   # field 22: starttime
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    age = uptime - started_ticks / os.sysconf("SC_CLK_TCK")
    return now - max(age, 0.0)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(doc: dict, name: str) -> dict:
    for cell in doc["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return load_json(BENCH_DIR / "workloads" / f"{cell}.json")["limits"]


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py`` (metric names carry dots, so the file is
    loaded by path, not imported by module name)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(doc: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports: a
    metric with ``workloads`` in the cells it lists; without it, an
    end-to-end metric in every cell, a per-layer one in every cell that
    reports the end-to-end metric it moves."""
    e2e = {m["name"] for m in doc["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    if kind == "end_to_end":
        return [m for m in doc["end_to_end"] if m["name"] in e2e]
    return [m for m in doc["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def forbidden_modules(names) -> list[str]:
    """The loaded modules whose top-level name, compared whole, is one
    of :data:`FORBIDDEN` (``kubeflow_tpu_torch`` is not
    ``kubeflow_tpu``)."""
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


def program_root_ok() -> str | None:
    """None when the program imports from this checkout; else why not
    (a checkout without the program, or one installed elsewhere)."""
    try:
        module = importlib.import_module(PROGRAM)
    except ImportError as exc:
        return f"cannot import {PROGRAM}: {exc}"
    where = Path(module.__file__).resolve().parent
    if where.parent != ROOT:
        return f"{PROGRAM} imports from {where}, not from {ROOT}"
    return None


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's configuration, mix and limits,
    the run's arguments, the process's start time, and on several cards
    its ``world.World``."""

    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    setup_start: float
    device: Any = None
    world: Any = None


@dataclasses.dataclass
class Reading:
    """What a traced run hands the per-layer readers: ``trace`` (a
    ``tracing.Trace`` of the steady sub-window, or None; rank 0's on
    several cards), ``counts`` (the benchmark's own counts: shapes,
    pairs, images, the configuration) and, on several cards,
    ``device_busy``: (busy, window) seconds averaged over the cards. A
    reader that finds nothing it needs returns None."""

    trace: Any = None
    counts: dict = dataclasses.field(default_factory=dict)
    device_busy: tuple | None = None


@dataclasses.dataclass
class Outcome:
    """What a driver returns. ``checks`` are (name, value, limit): the
    run is correct when every value is at most its limit."""

    end_to_end: dict
    attempted: int
    failed: int
    checks: list
    memory_peak_bytes: int
    reading: Reading | None = None
    notes: dict = dataclasses.field(default_factory=dict)


def correct(checks) -> bool:
    return all(math.isfinite(v) and v <= limit for _, v, limit in checks)


def check_lines(checks) -> list[str]:
    return [f"check {name} {value!r} limit {limit!r} "
            f"{'ok' if math.isfinite(value) and value <= limit else 'FAIL'}"
            for name, value, limit in checks]


def result(outcome: Outcome, doc: dict, cell: str, trace: bool,
           device: dict, breakdown: dict | None) -> dict:
    """The last line of standard output."""
    metrics = {}
    if trace:
        for entry in cell_metrics(doc, cell, "per_layer"):
            value = metric_reader(entry["name"]).read(outcome.reading)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        for entry in cell_metrics(doc, cell, "end_to_end"):
            if entry["name"] in outcome.end_to_end:
                metrics[entry["name"]] = {
                    "value": outcome.end_to_end[entry["name"]],
                    "unit": entry["unit"]}
    line = {"correct": correct(outcome.checks),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in outcome.checks}
    return line


def log(message: str) -> None:
    sys.stderr.write(message + "\n")
    sys.stderr.flush()

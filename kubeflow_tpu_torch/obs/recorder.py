"""Flight recorder: a bounded black-box ring of serving-cycle snapshots.

A copy of ``kubeflow_tpu/obs/recorder.py``: always-on, bounded recording
of the last N scheduler cycles (per-phase durations, queue depth, batch
occupancy, memory watermark, the active trace id), so that when an alert
fires the window leading up to it is already captured and can be dumped
for offline forensics. Recording is a dict build and a lock-guarded
deque append per cycle. Dumps are JSONL files written atomically (tmp +
``os.replace``) and rate-limited. :class:`~kubeflow_tpu_torch.obs.alerts.
SloEngine` dumps on every pending->firing transition when given a
recorder; the gateway's ``/debug/flightrecord`` serves the live ring.

Environment:

- ``OBS_FLIGHT_CAPACITY``       — ring size (default 256 snapshots)
- ``OBS_FLIGHT_DIR``            — where dumps land (default the working
  directory)
- ``OBS_FLIGHT_MIN_INTERVAL_S`` — minimum seconds between dumps
  (default 60; ``force=True`` bypasses)
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable

from kubeflow_tpu_torch.obs.envknob import env_number

log = logging.getLogger(__name__)


class FlightRecorder:
    """Bounded ring of structured snapshots + rate-limited atomic dumps.

    ``record()`` runs on the scheduler thread while ``snapshots()``/
    ``to_dict()`` run on HTTP handler threads and ``dump()`` on whatever
    thread ticks the SLO engine — one lock serializes the ring; the artifact write happens
    OUTSIDE it (file I/O under a hot-loop lock would be its own
    latency bug)."""

    def __init__(
        self,
        capacity: int | None = None,
        dump_dir: str | None = None,
        min_dump_interval_s: float | None = None,
        clock: Callable[[], float] = time.time,
        name: str = "flightrecord",
    ):
        if capacity is None:
            capacity = env_number("OBS_FLIGHT_CAPACITY", 256, cast=int)
        self.capacity = max(1, int(capacity))
        self.dump_dir = (dump_dir if dump_dir is not None
                         else os.environ.get("OBS_FLIGHT_DIR", "."))
        if min_dump_interval_s is None:
            min_dump_interval_s = env_number(
                "OBS_FLIGHT_MIN_INTERVAL_S", 60.0
            )
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._last_dump_at: float | None = None
        self._dump_seq = 0
        self.dumps_total = 0
        self.dumps_suppressed = 0
        self.last_dump_path: str | None = None

    # ---- recording -------------------------------------------------------
    def record(self, kind: str, **fields) -> dict:
        """Append one snapshot. Stamps a monotonic sequence number, the
        recorder clock, and — unless the caller provided one — the
        trace id of the current sampled span, so a snapshot links back
        to the exact trace that produced it."""
        snap = {"kind": kind, **fields}
        if "trace_id" not in snap:
            from kubeflow_tpu_torch.obs.trace import current_span

            span = current_span()
            snap["trace_id"] = (
                span.context.trace_id
                if span is not None and span.context.sampled else None
            )
        with self._lock:
            self._seq += 1
            snap["seq"] = self._seq
            snap["ts"] = self._clock()
            self._ring.append(snap)
        return snap

    # ---- reading ---------------------------------------------------------
    def snapshots(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def to_dict(self) -> dict:
        """The ``/debug/flightrecord`` document."""
        with self._lock:
            snapshots = list(self._ring)
            return {
                "capacity": self.capacity,
                "recorded": self._seq,
                "dumps": self.dumps_total,
                "dumps_suppressed": self.dumps_suppressed,
                "last_dump_path": self.last_dump_path,
                "snapshots": snapshots,
            }

    # ---- dumping ---------------------------------------------------------
    def dump(self, reason: str, force: bool = False) -> str | None:
        """Write the current ring as one JSONL artifact (header line
        with the trigger reason, then one line per snapshot), atomically
        via tmp + ``os.replace``. Rate-limited: within
        ``min_dump_interval_s`` of the previous dump the call is
        counted and skipped (an alert storm must not turn the recorder
        into a disk-filling amplifier) unless ``force``. Returns the
        artifact path, or None when suppressed or the write failed —
        a dump must never take down the tick that triggered it."""
        now = self._clock()
        with self._lock:
            if (
                not force
                and self._last_dump_at is not None
                and now - self._last_dump_at < self.min_dump_interval_s
            ):
                self.dumps_suppressed += 1
                return None
            # Reserve the slot under the lock so two concurrent firing
            # ticks cannot both pass the rate check and double-write.
            prev_dump_at = self._last_dump_at
            self._last_dump_at = now
            seq = self._dump_seq
            self._dump_seq += 1
            snapshots = list(self._ring)
        header = {
            "kind": "flight_dump",
            "reason": reason,
            "at": now,
            "snapshots": len(snapshots),
            "capacity": self.capacity,
        }
        path = os.path.join(self.dump_dir, f"{self.name}-{seq:04d}.jsonl")
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(json.dumps(header, default=str) + "\n")
                for snap in snapshots:
                    fh.write(json.dumps(snap, default=str) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)  # the rename IS the commit
        except OSError as exc:
            log.warning("flight-recorder dump to %s failed: %s", path, exc)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            with self._lock:
                # Release the rate-limit slot (unless a later dump
                # re-reserved it meanwhile): the artifact was lost, so
                # the next firing transition must retry, not sit out
                # the interval behind a write that never landed.
                if self._last_dump_at == now:
                    self._last_dump_at = prev_dump_at
            return None
        with self._lock:
            self.dumps_total += 1
            self.last_dump_path = path
        log.info("flight recorder dumped %d snapshot(s) to %s (%s)",
                 len(snapshots), path, reason)
        return path

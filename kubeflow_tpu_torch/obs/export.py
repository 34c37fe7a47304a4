"""A JSONL sink (stdlib only).

A trimmed copy of ``kubeflow_tpu/obs/export.py`` as far as step
telemetry uses it: :class:`JsonlExporter`, one JSON line per record,
appended under a lock to a file whose directory it creates. The span
ring, the fan-out and the trace-tree assembly are left out: the port
exports no spans.

Environment: ``OBS_JSONL_MAX_BYTES`` (rotate to ``<path>.1`` before a
write would pass it; unset means unbounded).
"""

from __future__ import annotations

import json
import os
import threading


class JsonlExporter:
    """Append records to a JSONL file, one line each. The parent
    directory is created (an unwritable one fails the first write, not
    the constructor); writes are serialized so concurrent records cannot
    interleave half-lines, and the handle is opened once and flushed per
    line. With ``max_bytes`` (or ``OBS_JSONL_MAX_BYTES``) a write that
    would pass the cap first rotates the file to ``<path>.1``."""

    def __init__(self, path: str, max_bytes: int | None = None):
        self.path = path
        if max_bytes is None:
            raw = os.environ.get("OBS_JSONL_MAX_BYTES")
            if raw:
                try:
                    max_bytes = int(raw)
                except ValueError:
                    max_bytes = None
        self.max_bytes = (int(max_bytes) if max_bytes and int(max_bytes) > 0
                          else None)
        self._written = 0
        self._lock = threading.Lock()
        self._fh = None
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
        except OSError:
            pass  # the first export raises; its caller decides

    def export(self, record: dict) -> None:
        line = json.dumps(record, default=str)
        encoded = line.encode("utf-8") + b"\n"
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, "a", encoding="utf-8")
                try:
                    self._written = os.fstat(self._fh.fileno()).st_size
                except OSError:
                    self._written = 0
            if (self.max_bytes is not None and self._written > 0
                    and self._written + len(encoded) > self.max_bytes):
                self._fh.close()
                self._fh = None
                try:
                    os.replace(self.path, self.path + ".1")
                except OSError:
                    pass  # keep appending: the stream beats the cap
                self._fh = open(self.path, "a", encoding="utf-8")
                self._written = 0
            self._fh.write(line + "\n")
            self._fh.flush()
            self._written += len(encoded)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None


__all__ = ["JsonlExporter"]

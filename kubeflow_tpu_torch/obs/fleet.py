"""The data plane's half of the fleet's goodput card.

A trimmed copy of ``kubeflow_tpu/obs/fleet.py`` as far as the train loop
uses it: :class:`GoodputAnnotationPublisher`, which lands a goodput
meter's ratio on the owning custom resource as an annotation, and the
API coordinates it writes under. The per-namespace rollup the manager
and the dashboard read belongs to the control plane and is left out.

Duck-typed on the api: anything with ``patch_merge(api_version, kind,
name, patch, namespace)`` (a Kubernetes client, or a stand-in in tests).
"""

from __future__ import annotations

import logging
import time
from typing import Callable

log = logging.getLogger(__name__)

# CR coordinates, mirrored from the controllers (API contract).
NOTEBOOK_API = "kubeflow.org/v1beta1"

# The annotation that carries train_goodput_ratio from the training pod
# to the fleet cards.
GOODPUT_ANNOTATION = "obs.kubeflow-tpu.org/goodput-ratio"


class GoodputAnnotationPublisher:
    """Publishes a goodput meter's summary onto the owning CR as
    :data:`GOODPUT_ANNOTATION`. Rate-limited and best-effort: a failing
    api is logged and never fails, or stalls, the loop it describes.

    Shaped for ``run_with_checkpointing(goodput_publish=...)``: called
    with ``meter.summary()`` at each save cadence, :meth:`flush` once at
    exit."""

    def __init__(self, api, namespace: str, name: str,
                 kind: str = "Notebook", api_version: str = NOTEBOOK_API,
                 min_interval_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.api = api
        self.namespace = namespace
        self.name = name
        self.kind = kind
        self.api_version = api_version
        self.min_interval_s = float(min_interval_s)
        self._clock = clock
        self._last_publish: float | None = None
        self.publishes = 0

    def __call__(self, summary: dict) -> None:
        now = self._clock()
        if (self._last_publish is not None
                and now - self._last_publish < self.min_interval_s):
            return
        self.flush(summary)

    def flush(self, summary: dict) -> None:
        """Publish whatever the rate limit says: the exit path, so a run
        that just published on cadence still lands its final ratio."""
        ratio = summary.get("goodput_ratio")
        if ratio is None:
            return
        now = self._clock()
        try:
            self.api.patch_merge(
                self.api_version, self.kind, self.name,
                {"metadata": {"annotations": {
                    GOODPUT_ANNOTATION: f"{float(ratio):.4f}"}}},
                self.namespace)
        except Exception as exc:
            log.debug("goodput publish failed for %s/%s: %s",
                      self.namespace, self.name, exc)
            return
        self._last_publish = now
        self.publishes += 1


__all__ = ["GOODPUT_ANNOTATION", "NOTEBOOK_API",
           "GoodputAnnotationPublisher"]

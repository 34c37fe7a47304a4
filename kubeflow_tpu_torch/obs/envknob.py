"""Shared env-knob parsing for the port's obs stack, the autopilot and
the gateway.

A copy of ``kubeflow_tpu/obs/envknob.py``. Every knob follows one
contract: missing, malformed, or (where a floor applies) out-of-range
values fall back to the default, so a bad knob never crashes an import
or a hot loop. This module imports nothing from ``obs``.
"""

from __future__ import annotations

import os
from typing import Callable


def env_bool(name: str, default: bool = False) -> bool:
    """Read env var ``name`` as a truthy flag (``1``/``true``/``yes``,
    case-insensitive); ``default`` when unset."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.lower() in ("1", "true", "yes")


def env_number(
    name: str,
    default: float | int,
    cast: Callable = float,
    minimum: float | int | None = None,
):
    """Read env var ``name`` through ``cast`` (``float``/``int``),
    returning ``default`` when unset, unparsable, or below
    ``minimum``."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = cast(raw)
    except ValueError:
        return default
    if minimum is not None and value < minimum:
        return default
    return value

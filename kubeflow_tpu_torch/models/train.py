"""Training state and loop of the port.

The counterpart of ``kubeflow_tpu/models/train.py`` as far as the LM
needs it: :class:`TrainState` and :func:`run_steps`. The reference's
step is a jitted pure function that donates its state; the port's step
updates the state's tensors in place and returns the same object.
ResNet training, checkpointed runs and step telemetry belong to later
slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass
class TrainState:
    """``step`` (a host int), ``params`` (a nested dict of tensors that
    require grad), ``opt_state`` (the optimizer's state), ``tx`` (the
    optimizer, with ``init``/``update``) and ``apply_fn`` (the model:
    ``apply_fn(params, tokens, segment_ids)``)."""

    step: int
    params: dict[str, Any]
    opt_state: Any
    tx: Any
    apply_fn: Callable


def run_steps(step, state, batches, telemetry=None):
    """Drive ``step`` over ``batches`` (an iterable of batch dicts),
    returning ``(state, last_metrics)``. Steps stay asynchronous on the
    card: nothing here waits for the device."""
    if telemetry is not None:
        raise NotImplementedError(
            "step telemetry belongs to the hooks slice of the port "
            "(ROADMAP A11)")
    metrics = None
    for batch in batches:
        state, metrics = step(state, batch)
    return state, metrics

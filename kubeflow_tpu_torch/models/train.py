"""Training state and loops of the port.

The counterpart of ``kubeflow_tpu/models/train.py`` as far as the LM
needs it: :class:`TrainState`, :func:`run_steps` and the checkpointed
loop :func:`run_with_checkpointing` with :class:`RunReport` and
:func:`realign_batches`. The reference's step is a jitted pure function
that donates its state; the port's step updates the state's tensors in
place and returns the same object, so a background save snapshots the
state to host memory before the next step runs (``models/checkpoint``).
ResNet training, meshes, step telemetry, goodput and the autopilot's
cadence signal belong to later slices and raise here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import signal
import threading
import time
from typing import Any, Callable

log = logging.getLogger(__name__)


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


def _synced_step_seconds(metrics, t0: float) -> float:
    """Host-synced step wall time: reading the first metric waits for
    the step's device work before the clock is read."""
    if metrics:
        float(next(iter(metrics.values())))
    return time.perf_counter() - t0


@dataclasses.dataclass
class RunReport:
    """What a checkpointed run did: the numbers the chaos tier asserts
    lost-work bounds against."""

    resumed_from_step: int | None = None
    start_step: int = 0
    final_step: int = 0
    saves: int = 0
    preempted: bool = False
    # True when the resume was a cross-topology restore (saved under a
    # different world).
    resharded: bool = False


def realign_batches(batches, start_step, *, strict: bool = True):
    """Fast-forward a FRESH seeded iterator to the resume point
    (``start_step``: an int or a :class:`RunReport`). The skipped prefix
    is consumed, not indexed, so any seeded generator works; with
    ``strict`` an iterator that runs dry inside the skip raises instead
    of resuming at the wrong example."""
    step = (start_step.start_step if isinstance(start_step, RunReport)
            else int(start_step))
    if step < 0:
        raise ValueError(f"start_step must be >= 0, got {step}")
    iterator = iter(batches)
    for skipped in range(step):
        try:
            next(iterator)
        except StopIteration:
            if strict:
                raise ValueError(
                    f"batch iterator ran dry after {skipped} of {step} "
                    "skipped steps - the pipeline is shorter than the "
                    "checkpoint step, so the seed/order cannot match the "
                    "run that saved") from None
            break
    return iterator


def _refuse_unported(mesh, tp_rules, telemetry, goodput, goodput_publish,
                     cadence_signal) -> None:
    if mesh is not None or tp_rules is not None:
        raise NotImplementedError(
            "checkpointed runs on a mesh belong to the parallel/ slice of "
            "the port (ROADMAP A10)")
    if telemetry is not None or goodput is not None \
            or goodput_publish is not None:
        raise NotImplementedError(
            "step telemetry and the goodput meter belong to the hooks slice "
            "of the port (ROADMAP A11)")
    if cadence_signal is not None:
        raise NotImplementedError(
            "the autopilot's checkpoint-cadence signal belongs to the A5 "
            "leftovers of the port (ROADMAP A5 leftovers)")


def run_with_checkpointing(step_fn, state, batches, manager, *,
                           save_every_steps: int = 0,
                           save_every_s: float = 0.0, mesh=None,
                           tp_rules=None, telemetry=None, goodput=None,
                           goodput_publish=None, profiler=None,
                           recorder=None, cadence_signal=None,
                           install_signal_handler: bool = True,
                           clock=time.monotonic):
    """Drive ``step_fn`` over ``batches`` with the reference's
    preemption-to-resume contract:

    - **auto-resume**: before the first step the newest *valid*
      checkpoint under ``manager`` is restored (torn/corrupt steps are
      skipped) into the shape of ``state``, the template, and training
      continues from its step.
    - **cadence**: a background save every ``save_every_steps`` steps
      and/or every ``save_every_s`` seconds, whichever fires first; 0
      disables that trigger.
    - **preemption**: on SIGTERM the loop finishes the step in flight,
      takes one final *synchronous* save and returns with
      ``report.preempted`` set. The handler is installed only from the
      main thread and the previous one is restored on return.
    - **multi-process**: with ``manager.process_count > 1`` and a clock
      or signal trigger armed, process 0's decision at each step
      boundary ("run", "save" or "stop") is broadcast through
      ``manager.broadcast_from_zero`` and every rank obeys it.
    - **phases**: with a :class:`~kubeflow_tpu_torch.obs.PhaseProfiler`
      each iteration is split into ``fetch``, ``step`` (host-synced)
      and ``save``, plus ``restore`` for the resume; with a
      :class:`~kubeflow_tpu_torch.obs.FlightRecorder` each step lands
      one ``train_step`` snapshot.

    ``mesh``/``tp_rules`` (ROADMAP A10), ``telemetry``, ``goodput`` and
    ``goodput_publish`` (A11) and ``cadence_signal`` (A5 leftovers) are
    not ported and raise when given.

    Returns ``(state, RunReport)``. The caller owns data-order alignment
    with the global step (:func:`realign_batches`); the resume happens
    before the first batch is drawn.
    """
    _refuse_unported(mesh, tp_rules, telemetry, goodput, goodput_publish,
                     cadence_signal)
    report = RunReport()

    def _phase(name: str):
        return (profiler.phase(name) if profiler is not None
                else contextlib.nullcontext())

    with _phase("restore"):
        resumed = manager.restore_latest_valid(state)
    if resumed is None:
        step = _state_step(state)
    else:
        state, step = resumed
        report.resumed_from_step = step
        info = getattr(manager, "last_restore", None) or {}
        report.resharded = bool(info.get("cross_topology"))
        log.info("resumed from checkpoint step %d%s", step,
                 f" ({info.get('mismatch')})" if report.resharded else "")
    report.start_step = report.final_step = step

    stop = threading.Event()
    previous_handler = None
    if install_signal_handler:
        try:
            previous_handler = signal.signal(signal.SIGTERM,
                                             lambda *_: stop.set())
        except ValueError:
            previous_handler = None  # not the main thread: caller's job

    # Wall-clock and SIGTERM triggers are per-host observations; in a
    # multi-process world process 0's agreed token replaces them.
    agree = getattr(manager, "process_count", 1) > 1 and (
        bool(save_every_s) or install_signal_handler)
    last_save_at = clock()
    last_saved = step
    preempted = False

    def decide() -> str:
        """One decision per step boundary, taken BEFORE the next step is
        paid for, so a pending preemption never buys one more step."""
        due_clock = (bool(save_every_s)
                     and clock() - last_save_at >= save_every_s)
        token = "stop" if stop.is_set() else ("save" if due_clock else "run")
        if agree:
            token = manager.broadcast_from_zero(f"cadence-{step}", token)
        return token

    def cadence_due(token: str) -> bool:
        # The start step is already durable (fresh run: nothing to save;
        # resumed: it is the committed step restored).
        return step != last_saved and (
            (save_every_steps and step % save_every_steps == 0)
            or token == "save")

    batch_iter = iter(batches)
    done = object()
    try:
        while True:
            activation = (profiler.activate() if profiler is not None
                          else contextlib.nullcontext(None))
            with activation as phases:
                token = decide()
                if token == "stop":
                    preempted = True
                    break  # the final sync save below covers the step
                if cadence_due(token):
                    with _phase("save"):
                        # Multi-process, `token` is process 0's agreed
                        # decision; the local view survives only when a
                        # single process cannot diverge.
                        # analysis: allow[spmd-divergent-collective]
                        manager.save_async(step, state)
                    report.saves += 1
                    last_saved = step
                    last_save_at = clock()
                with _phase("fetch"):
                    batch = next(batch_iter, done)
                if batch is done:
                    break
                with _phase("step"):
                    t0 = time.perf_counter()
                    state, metrics = step_fn(state, batch)
                    step += 1
                    report.final_step = step
                    if profiler is not None:
                        # "step" means the step, not its async enqueue.
                        _synced_step_seconds(metrics, t0)
                if recorder is not None:
                    recorder.record(
                        "train_step", step=step,
                        phases={k: round(v, 6)
                                for k, v in (phases or {}).items()},
                        saves=report.saves,
                        memory=(profiler.watermark()
                                if profiler is not None else None))
        if preempted or (stop.is_set() and not agree):
            # Grace window: one last synchronous save (save() first
            # drains the in-flight background save), so at most the
            # in-flight step is lost.
            report.preempted = True
            if step > 0 or report.resumed_from_step is not None:
                with _phase("save"):
                    # analysis: allow[spmd-divergent-collective]
                    manager.save(step, state)
                report.saves += 1
        else:
            manager.wait()
    finally:
        if previous_handler is not None:
            signal.signal(signal.SIGTERM, previous_handler)
    return state, report


def _state_step(state) -> int:
    step = getattr(state, "step", None)
    if step is None and isinstance(state, dict):
        step = state.get("step")
    if step is None:
        return 0
    try:
        return int(step)
    except (TypeError, ValueError):
        return 0

"""Training state, the image train and eval steps, and the loops.

The counterpart of ``kubeflow_tpu/models/train.py``: :class:`TrainState`,
the image model's :func:`cross_entropy` (label smoothing),
:func:`create_train_state`, :func:`make_train_step` and
:func:`make_eval_step` (ResNet, with ``make_optimizer``'s Nesterov SGD
from ``models/optim``), :func:`run_steps` and the checkpointed loop
:func:`run_with_checkpointing` with :class:`RunReport` and
:func:`realign_batches`. The reference's step is a jitted pure function
that donates its state; the port's step updates the state's tensors in
place and returns the same object, so a background save snapshots the
state to host memory before the next step runs (``models/checkpoint``).

On a mesh (``parallel.make_mesh``) each rank's state holds its shards,
``state.placements`` records every leaf's placement
(:func:`state_shardings`), and the steps run the collectives by hand:
fsdp's gathers (``parallel.fsdp``), whose backward reduce-scatters, and
:func:`reduce_gradients` after the backward. A checkpointed run on a
mesh writes each rank's shards and resumes on another mesh
(``models/checkpoint``). On a pp mesh these steps leave pp inert, as the
reference's do: every pp rank holds the whole replica and steps the same
rows (the pipelined LM is ``models/pipeline_lm``). The loops take the
reference's hooks: step telemetry and the goodput meter
(``obs/telemetry``), the goodput annotation (``obs/fleet``) and the
autopilot's cadence signal (``autopilot/checkpoint``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import signal
import threading
import time
from typing import Any, Callable

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models.optim import (
    flatten,
    make_optimizer,
    trainable,
    tree_map_with_path,
)
from kubeflow_tpu_torch.obs.profile import span
from kubeflow_tpu_torch.parallel.collectives import (
    all_reduce,
    all_reduce_flat,
)
from kubeflow_tpu_torch.parallel.mesh import (
    AXES,
    gather_block,
    local_block,
    param_sharding,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    """``step`` (a host int), ``params`` (a nested dict of tensors that
    require grad), ``opt_state`` (the optimizer's state), ``tx`` (the
    optimizer, with ``init``/``update``), ``apply_fn`` (the model: the
    LM's ``apply_fn(params, tokens, segment_ids)``, ResNet's
    ``apply_fn(params, batch_stats, images, train)``) and
    ``batch_stats`` (BatchNorm running averages; empty for the LM). On a
    mesh, ``mesh`` and ``placements`` (:func:`state_shardings`) say
    which shard of each leaf this rank holds."""

    step: int
    params: dict[str, Any]
    opt_state: Any
    tx: Any
    apply_fn: Callable
    batch_stats: dict[str, Any] = dataclasses.field(default_factory=dict)
    mesh: Any = None
    placements: dict[str, dict[str, tuple]] | None = None


def state_shardings(state, mesh, tp_rules: dict | None = None) -> dict:
    """Canonical placement per leaf, ``{"params": {path: placement},
    "batch_stats": {...}}`` keyed by ``flatten`` paths, for a state whose
    leaves are WHOLE (meshless). The optimizer's moments and trace take
    their parameter's placement. ``tp_rules`` must match what the model
    passed at creation time (e.g. ``transformer.LM_TP_RULES``) or a
    tp-sharded state would come back tp-replicated."""
    return {group: {path: param_sharding(mesh, tuple(path.split("/")),
                                         leaf, tp_rules=tp_rules)
                    for path, leaf in flatten(getattr(state, group))}
            for group in ("params", "batch_stats")}


def gradient_axes(placement: tuple, data_axes: tuple,
                  whole_over_sp: bool = False) -> tuple:
    """The axes a leaf's gradient is all-reduced over after the backward:
    the axes that split the data (``data_axes``), less fsdp where fsdp
    shards the leaf (its gather's backward reduce-scattered the gradient
    already, ``parallel.fsdp.GatherShard``), less sp where the leaf's
    layer ran on the whole sequence (``whole_over_sp``: the MoE layer's
    gradients are whole and equal on every sp rank)."""
    return tuple(a for a in data_axes
                 if not (a == "fsdp" and "fsdp" in placement)
                 and not (a == "sp" and whole_over_sp))


def reduce_gradients(mesh, grads, axes: list) -> list:
    """Sum each leaf's gradient over its ``axes`` (:func:`gradient_axes`;
    none for a leaf whose gradient is complete), one all-reduce per
    (axes, dtype) bucket in the leaves' order. Never over tp or ep, which
    replicate the computation."""
    out = list(grads)
    buckets: dict[tuple, list[int]] = {}
    for i, (g, leaf_axes) in enumerate(zip(grads, axes)):
        if leaf_axes:
            buckets.setdefault((leaf_axes, g.dtype), []).append(i)
    for (leaf_axes, _), idx in buckets.items():
        reduced = all_reduce_flat([out[i] for i in idx],
                                  mesh.group(leaf_axes))
        for i, g in zip(idx, reduced):
            out[i] = g
    return out


def cross_entropy(logits, labels, smoothing: float = 0.1):
    """Mean softmax cross entropy against one-hot labels smoothed to
    ``onehot * (1 - smoothing) + smoothing / classes``, in f32."""
    return F.cross_entropy(logits.float(), labels.long(),
                           label_smoothing=smoothing)


def _accuracy(logits, labels):
    return (logits.argmax(dim=-1) == labels.long()).float().mean()


def create_train_state(model, seed: int, input_shape: tuple[int, ...],
                       tx=None, mesh=None, device=None) -> TrainState:
    """The image model's TrainState: f32 parameters that require grad and
    the running statistics from ``model.init_variables(seed)`` for
    images of ``input_shape`` (N, H, W, C), on the card unless
    ``device="cpu"``, and ``make_optimizer()`` by default.

    With a ``mesh`` the state is initialised whole from the same seed in
    host memory, then each rank moves only its shard of every leaf of
    the parameters, the SGD trace and ``batch_stats`` to the mesh's
    device, at ``param_sharding`` with no tp rules, as the reference
    places them (``shard_state``)."""
    if mesh is not None:
        device = "cpu"
    tx = tx or make_optimizer()
    variables = model.init_variables(seed, in_channels=input_shape[-1],
                                     device=resolve_device(device))
    params = trainable(variables["params"])
    state = TrainState(step=0, params=params, opt_state=tx.init(params),
                       tx=tx, apply_fn=model,
                       batch_stats=variables["batch_stats"])
    if mesh is None:
        return state
    from kubeflow_tpu_torch.models.convert import shard_state

    return shard_state(state, mesh)


# The axes that split an image batch (its rows).
IMAGE_DATA_AXES = ("dp", "fsdp")


def make_train_step(mesh=None, smoothing: float = 0.1):
    """The image step: ``step(state, batch)`` with batch = {"image": (N,
    H, W, C), "label": (N,) int} computes the smoothed loss and its
    gradients in train mode (batch statistics), applies the optimizer IN
    PLACE, takes the new running averages as ``state.batch_stats``, and
    returns ``(state, {"loss", "accuracy"})`` (0-d tensors).

    With a ``mesh`` the state must be on it (``create_train_state(mesh=)``)
    and every rank passes the WHOLE batch: the step keeps this rank's
    (dp, fsdp) rows, takes every BatchNorm's moments over the whole batch
    (its sums all-reduced over the (dp, fsdp) group, forward and
    backward), scales the loss by the rank's share of the batch so the
    ranks' losses sum to the global mean, has the model gather its
    fsdp-sharded weights one piece at a time (the stem, each block, the
    head: ``ResNet.__call__``), again in the backward, where their
    gradients are reduce-scattered, and all-reduces the gradients over
    the rest of (dp, fsdp) after it (:func:`reduce_gradients`). Loss and accuracy are the
    whole batch's means.

    The step runs under ``obs.profile.span`` ranges that a trace reads:
    ``train.step`` around it all, ``train.forward`` through the loss,
    ``train.backward`` around the gradients (and their reductions on a
    mesh), ``train.optimizer`` around the SGD update and what follows
    it."""
    group = None
    if mesh is not None:
        group = mesh.group(IMAGE_DATA_AXES)

    def step(state, batch):
        with span("train.step"):
            return _step(state, batch)

    def _step(state, batch):
        if state.mesh is not mesh:
            raise ValueError("the state is not on this mesh: "
                             "create_train_state(..., mesh=mesh)")
        with span("train.forward"):
            images, labels = batch["image"], batch["label"]
            stats, share, on_mesh = state.batch_stats, 1.0, {}
            if mesh is not None:
                placements = state.placements
                rows = mesh.slice(IMAGE_DATA_AXES, images.shape[0])
                share = (rows.stop - rows.start) / images.shape[0]
                images, labels = images[rows], labels[rows]
                stats = tree_map_with_path(
                    lambda path, t: gather_block(
                        mesh, t, placements["batch_stats"][path]), stats)
                on_mesh = {"mesh": mesh, "placements": placements["params"]}
            logits, new_stats = state.apply_fn(state.params, stats, images,
                                               train=True, group=group,
                                               **on_mesh)
            loss = cross_entropy(logits, labels, smoothing) * share
        with span("train.backward"):
            paths = [path for path, _ in flatten(state.params)]
            grads = torch.autograd.grad(
                loss, [t for _, t in flatten(state.params)])
            if mesh is not None:
                grads = reduce_gradients(mesh, grads, [
                    gradient_axes(placements["params"][p], IMAGE_DATA_AXES)
                    for p in paths])
                new_stats = tree_map_with_path(
                    lambda path, t: local_block(
                        mesh, t, placements["batch_stats"][path]), new_stats)
        with span("train.optimizer"), torch.no_grad():
            state.tx.update(grads, state.opt_state, state.params)
            metrics = torch.stack([loss.detach(),
                                   _accuracy(logits, labels) * share])
            if group is not None:
                all_reduce(metrics, group)
            state.batch_stats = new_stats
            state.step += 1
        return state, {"loss": metrics[0], "accuracy": metrics[1]}

    return step


def make_eval_step():
    """``eval_step(state, batch) -> {"loss", "accuracy"}``: eval mode
    (running averages), no smoothing, no gradient."""

    @torch.no_grad()
    def eval_step(state, batch):
        logits = state.apply_fn(state.params, state.batch_stats,
                                batch["image"], train=False)
        return {"loss": cross_entropy(logits, batch["label"], 0.0),
                "accuracy": _accuracy(logits, batch["label"])}

    return eval_step


def run_steps(step, state, batches, telemetry=None):
    """Drive ``step`` over ``batches`` (an iterable of batch dicts),
    returning ``(state, last_metrics)``.

    With a :class:`~kubeflow_tpu_torch.obs.telemetry.StepTelemetry`,
    every step is timed and observed (wall time, examples/s, MFU): on
    the card by an event pair read one step late, so the host stays a
    step ahead of the card, on the CPU host-synced (``_StepTimer``).
    Without it nothing here waits for the device."""
    metrics = None
    timer = _StepTimer()
    for batch in batches:
        if telemetry is None:
            state, metrics = step(state, batch)
            continue
        timer.start()
        state, metrics = step(state, batch)
        for size, seconds in timer.stop(_batch_size(batch), metrics):
            telemetry.observe(size, seconds)
    for size, seconds in timer.flush():
        telemetry.observe(size, seconds)
    return state, metrics


def _batch_size(batch) -> int:
    return len(next(iter(batch.values())))


def _step_device(metrics):
    """The CUDA device a step's first metric lives on, or None."""
    value = next(iter(metrics.values()), None) if metrics else None
    if torch.is_tensor(value) and value.is_cuda:
        return value.device
    return None


def _timing_event(device):
    """A timing event recorded on ``device``'s current stream."""
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


class _StepTimer:
    """Wall seconds of a loop's steps, without a sync a step on the card.

    ``start()`` before a step, ``stop(batch_size, metrics)`` after it
    and ``flush()`` before anything that must see every step counted
    (a save, a preemption, the loop's end). Each returns the steps it
    completed as ``(batch_size, seconds)``. A step whose metrics live on
    the CUDA device the previous step's did is timed by a pair of events
    on that device's current stream, and read one step late: ``stop``
    waits only for the previous step's end event, which the card passes
    while it runs this step. Any other step (the first, or one on the
    CPU) is host-synced: reading its first metric waits for its work
    before the host clock is read."""

    def __init__(self):
        self._device = None
        self._t0 = 0.0
        self._start = None
        self._pending = None

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._start = (None if self._device is None
                       else _timing_event(self._device))

    def stop(self, batch_size: int, metrics) -> list[tuple[int, float]]:
        device = _step_device(metrics)
        if self._start is not None and device == self._device:
            end = _timing_event(device)
            done = self.flush()
            self._pending = (batch_size, self._start, end)
            return done
        done = self.flush()
        if metrics:
            float(next(iter(metrics.values())))
        self._device = device
        return done + [(batch_size, time.perf_counter() - self._t0)]

    def flush(self) -> list[tuple[int, float]]:
        if self._pending is None:
            return []
        batch_size, start, end = self._pending
        self._pending = None
        end.synchronize()
        return [(batch_size, start.elapsed_time(end) / 1e3)]


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
    - **mesh**: with ``mesh`` the state trains on it (a whole state is
      laid onto it first with ``shard_state(state, mesh, tp_rules)``,
      the LM at its model's layout; one on another mesh is refused), its saves record the mesh's shape
      in the manifest's fingerprint and write each rank's shards, and the
      resume reads each rank's region of whatever mesh saved the step:
      ``report.resharded`` says the saved and live fingerprints differ
      (the restore outcome ``resumed_cross_topology``). The manager must
      span the world (``process_count`` = its size).
    - **goodput**: with a :class:`~kubeflow_tpu_torch.obs.telemetry.
      GoodputMeter` every completed step's seconds count as useful
      and the resume is measured as ``restore`` downtime
      (``reshard`` when it was cross-topology); ``goodput_publish`` (a
      callable taking ``meter.summary()``, as a
      :class:`~kubeflow_tpu_torch.obs.fleet.GoodputAnnotationPublisher`)
      is called at every save cadence and its ``flush`` once at exit,
      best-effort: a failing publisher is logged and never fails the
      loop. ``telemetry`` (a :class:`~kubeflow_tpu_torch.obs.telemetry.
      StepTelemetry`) observes every completed step.
    - **phases**: with a :class:`~kubeflow_tpu_torch.obs.PhaseProfiler`
      each iteration is split into ``fetch``, ``step``, ``save`` and
      ``publish``, plus ``restore`` for the resume (the interval goodput
      charges as downtime); telemetry observed inside the iteration
      carries its digest; with a
      :class:`~kubeflow_tpu_torch.obs.FlightRecorder` each step lands
      one ``train_step`` snapshot. With any of telemetry, goodput or a
      profiler, steps are timed: on the card by an event pair on the
      step's stream, observed one step late (``step`` then holds the
      step's enqueue and the wait for the step before it) and flushed
      before a save, at a preemption and at the loop's end; on the CPU
      host-synced. With none, nothing waits for the device.
    - **alert-aware cadence**: ``cadence_signal`` is a zero-arg callable
      returning a save-interval multiplier in (0, 1] (as
      :meth:`~kubeflow_tpu_torch.autopilot.CheckpointCadenceActuator.
      factor`): below 1, the wall-clock cadence fires ``factor`` times
      sooner and the step cadence tightens to ``save_every_steps *
      factor``. It is read only in process 0's view of the step-boundary
      decision, which is broadcast, so ranks never act on local
      readings; one that raises or reads outside (0, 1] reads as 1.0.

    Returns ``(state, RunReport)``. The caller owns data-order alignment
    with the global step (:func:`realign_batches`); the resume happens
    before the first batch is drawn.
    """
    report = RunReport()
    if mesh is not None:
        state = _onto_mesh(state, mesh, tp_rules, manager)

    def _phase(name: str):
        return (profiler.phase(name) if profiler is not None
                else contextlib.nullcontext())

    def _resume():
        resumed = manager.restore_latest_valid(state)
        if resumed is None:
            return state, _state_step(state)
        new_state, step = resumed
        report.resumed_from_step = step
        info = getattr(manager, "last_restore", None) or {}
        report.resharded = bool(info.get("cross_topology"))
        log.info("resumed from checkpoint step %d%s", step,
                 f" ({info.get('mismatch')})" if report.resharded else "")
        return new_state, step

    with _phase("restore"):
        # The profiler's restore phase and goodput's restore (or
        # reshard) downtime measure the same interval.
        if goodput is not None:
            with goodput.downtime("restore") as span:
                state, step = _resume()
                if report.resharded:
                    span.kind = "reshard"
        else:
            state, step = _resume()
    report.start_step = report.final_step = step

    stop = threading.Event()
    previous_handler = None
    if install_signal_handler:
        try:
            previous_handler = signal.signal(signal.SIGTERM,
                                             lambda *_: stop.set())
        except ValueError:
            previous_handler = None  # not the main thread: caller's job

    # Wall-clock, SIGTERM and alert-signal triggers are per-host
    # observations; in a multi-process world process 0's agreed token
    # replaces them.
    agree = getattr(manager, "process_count", 1) > 1 and (
        bool(save_every_s) or install_signal_handler
        or cadence_signal is not None)
    last_save_at = clock()
    last_saved = step
    preempted = False

    def publish_goodput(final: bool = False) -> None:
        if goodput is None or goodput_publish is None:
            return
        # The exit publish bypasses a publisher's rate limit.
        publish = (getattr(goodput_publish, "flush", goodput_publish)
                   if final else goodput_publish)
        try:
            publish(goodput.summary())
        except Exception:
            # Telemetry never fails the loop it describes.
            log.debug("goodput publish failed", exc_info=True)

    def cadence_factor() -> float:
        """The alert-aware save-interval multiplier in (0, 1]; anything
        unusable reads as 1.0."""
        if cadence_signal is None:
            return 1.0
        try:
            factor = float(cadence_signal())
        except Exception:
            log.debug("checkpoint cadence signal failed", exc_info=True)
            return 1.0
        if not factor > 0.0:
            return 1.0
        return min(factor, 1.0)

    def decide() -> str:
        """One decision per step boundary (a pending SIGTERM, the
        wall-clock cadence, the alert-tightened cadence), taken BEFORE
        the next step is paid for, so a pending preemption never buys one
        more step. In a multi-process world the token is process 0's."""
        factor = cadence_factor()
        due_clock = (bool(save_every_s)
                     and clock() - last_save_at >= save_every_s * factor)
        # A tightened step cadence fires between the modulo points; it is
        # issued as a "save" token so that ranks obey process 0's view.
        due_steps_tight = (
            factor < 1.0 and bool(save_every_steps) and step != last_saved
            and step - last_saved >= max(1, int(round(save_every_steps
                                                      * factor))))
        token = "stop" if stop.is_set() else (
            "save" if (due_clock or due_steps_tight) else "run")
        if agree:
            token = manager.broadcast_from_zero(f"cadence-{step}", token)
        return token

    def cadence_due(token: str) -> bool:
        # The start step is already durable (fresh run: nothing to save;
        # resumed: it is the committed step restored).
        return step != last_saved and (
            (save_every_steps and step % save_every_steps == 0)
            or token == "save")

    timer = (_StepTimer() if (telemetry is not None or goodput is not None
                              or profiler is not None) else None)

    def observe(steps) -> None:
        for batch_size, seconds in steps:
            if telemetry is not None:
                telemetry.observe(batch_size, seconds)
            if goodput is not None:
                goodput.observe_step(seconds)

    def flush() -> None:
        if timer is not None:
            observe(timer.flush())

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
                    flush()
                    break  # the final sync save below covers the step
                if cadence_due(token):
                    flush()
                    with _phase("save"):
                        # Multi-process, `token` is process 0's agreed
                        # decision; the local view survives only when a
                        # single process cannot diverge.
                        # analysis: allow[spmd-divergent-collective]
                        manager.save_async(step, state)
                    report.saves += 1
                    last_saved = step
                    last_save_at = clock()
                    with _phase("publish"):
                        publish_goodput()
                with _phase("fetch"):
                    batch = next(batch_iter, done)
                if batch is done:
                    flush()
                    break
                with _phase("step"):
                    if timer is not None:
                        timer.start()
                    state, metrics = step_fn(state, batch)
                    step += 1
                    report.final_step = step
                    completed = (timer.stop(_batch_size(batch), metrics)
                                 if timer is not None else [])
                observe(completed)
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
        with _phase("publish"):
            publish_goodput(final=True)
    finally:
        if previous_handler is not None:
            signal.signal(signal.SIGTERM, previous_handler)
    return state, report


def _onto_mesh(state, mesh, tp_rules, manager):
    """The run's state on ``mesh`` and the manager's fingerprint stamped
    with the mesh's shape (assigned: the live mesh is this run's truth,
    as the reference's loop assigns ``mesh.devices.shape``)."""
    from kubeflow_tpu_torch.models.convert import shard_state

    if getattr(state, "mesh", None) is None:
        state = shard_state(state, mesh, tp_rules)
    elif state.mesh is not mesh:
        raise ValueError("the state is on another mesh than the run's")
    world = mesh.size(AXES)
    if getattr(manager, "process_count", world) != world:
        raise ValueError(
            f"a run on a mesh of {world} ranks needs a manager with "
            f"process_count={world}, not {manager.process_count}")
    if hasattr(manager, "fingerprint"):
        manager.fingerprint["mesh"] = [int(d) for d in mesh.spec.shape]
    return state


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

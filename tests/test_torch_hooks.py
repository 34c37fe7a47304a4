"""The train loop's hooks: the port's ``run_steps`` and
``run_with_checkpointing`` (``kubeflow_tpu_torch/models/train.py``) with
step telemetry, the goodput meter, its annotation publisher
(``obs/fleet.py``) and the checkpoint-cadence actuator
(``autopilot/checkpoint.py``), replayed beside the JAX package's loop
and hooks on the same scenarios:

- ``tests/test_autopilot.py::TestCheckpointCadence``: the actuator's
  factor over alert edges, objective filters, capacity readings and a
  flapping alert; the loop saving sooner under a tightened signal
  (clock-driven), a broken signal read as the normal cadence, and an
  8-step cadence tightened x0.25 to every 2 steps;
- ``tests/test_obs.py::TestStepTelemetry::test_train_loop_hook``:
  ``run_steps`` observing each step;
- ``tests/test_profile.py::TestTrainLoopIntegration``: telemetry with a
  profiler and a flight recorder, every record carrying ``phases``;
- ``tests/test_checkpoint.py::TestCrossTopologyRestore::
  test_run_with_checkpointing_resumes_on_refactored_mesh`` (and
  ``tests/test_elastic.py``'s goodput across incarnations): one meter
  through a run on a mesh and a resume on the refactored mesh, the port
  in a gloo world of 4 ranks (``tests/torch_world.py``), the reference
  on 4 and then 2 devices of its CPU mesh: ``reshard`` in the downtime,
  every step counted, 0 < ratio <= 1;
- the publisher against the reference's ``FakeApiServer``.

What is compared: save steps (and their clock times), reports, record
and snapshot counts, the downtime kinds, goodput step counts and the
annotations, equal between the two loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_world
from kubeflow_tpu import obs as ref_obs
from kubeflow_tpu.autopilot import ActuationGuard as RefGuard
from kubeflow_tpu.autopilot import CheckpointCadenceActuator as RefActuator
from kubeflow_tpu.k8s.fake import FakeApiServer
from kubeflow_tpu.models import checkpoint as ref_ckpt
from kubeflow_tpu.models import train as ref_train
from kubeflow_tpu.obs import fleet as ref_fleet
from kubeflow_tpu.obs.profile import PhaseProfiler as RefProfiler
from kubeflow_tpu.obs.recorder import FlightRecorder as RefRecorder
from kubeflow_tpu_torch.autopilot import ActuationGuard, CheckpointCadenceActuator
from kubeflow_tpu_torch.models import checkpoint as port_ckpt
from kubeflow_tpu_torch.models import train as port_train
from kubeflow_tpu_torch.obs import fleet, telemetry
from kubeflow_tpu_torch.obs.profile import PhaseProfiler
from kubeflow_tpu_torch.obs.recorder import FlightRecorder

PACKAGES = {
    "ref": dict(train=ref_train, ckpt=ref_ckpt, actuator=RefActuator,
                guard=RefGuard, telemetry=ref_obs.StepTelemetry,
                goodput=ref_obs.GoodputMeter, profiler=RefProfiler,
                recorder=RefRecorder, fleet=ref_fleet),
    "port": dict(train=port_train, ckpt=port_ckpt,
                 actuator=CheckpointCadenceActuator, guard=ActuationGuard,
                 telemetry=telemetry.StepTelemetry,
                 goodput=telemetry.GoodputMeter, profiler=PhaseProfiler,
                 recorder=FlightRecorder, fleet=fleet),
}


def both(fn):
    """``fn(package)`` for the reference and the port: (theirs, ours)."""
    return fn(PACKAGES["ref"]), fn(PACKAGES["port"])


class Clock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> float:
        self.t += s
        return self.t


def transition(slo="inference-ttft", speed="fast", to="firing",
               severity="critical", at=0.0, frm="pending"):
    return {"kind": "slo_alert", "slo": slo, "speed": speed,
            "severity": severity, "from": frm, "to": to, "burn": 20.0,
            "at": at, "namespace": None}


# ------------------------------------------------------- the actuator


def _script_edges(pkg, objectives=None):
    act = pkg["actuator"](objectives=objectives,
                          guard=pkg["guard"](min_interval_s=0.0,
                                             clock=Clock()))
    trace = [act.factor()]
    for t in (transition(slo="apiserver-availability"),
              transition(severity="warning", speed="slow"),
              transition(slo="train-goodput", severity="warning"),
              transition(slo="apiserver-availability", to="resolved",
                         frm="firing"),
              transition(slo="train-goodput", to="inactive",
                         frm="firing")):
        act.on_transition(t)
        trace.append(act.factor())
    return trace


@pytest.mark.parametrize("objectives", [None, ("train-goodput",)])
def test_actuator_edges_match_the_reference(objectives):
    theirs, ours = both(lambda pkg: _script_edges(pkg, objectives))
    assert ours == theirs
    assert 0.25 in ours and ours[-1] == 1.0


def test_actuator_capacity_trend_matches_the_reference():
    def run(pkg):
        readings = iter([16, 8, 8, 16, None, 4, 2])
        act = pkg["actuator"](capacity_fn=lambda: next(readings),
                              guard=pkg["guard"](min_interval_s=0.0,
                                                 clock=Clock()))
        trace = []
        for _ in range(7):
            act.on_tick()
            trace.append(act.factor())
        return trace

    theirs, ours = both(run)
    assert ours == theirs == [1.0, 0.25, 1.0, 1.0, 1.0, 1.0, 0.25]


def test_actuator_flap_emits_bounded_tighten_actions():
    def run(pkg):
        outcomes = []
        act = pkg["actuator"](guard=pkg["guard"](min_interval_s=600.0,
                                                 clock=Clock()))
        act._emit = lambda outcome, **d: outcomes.append(outcome)
        for i in range(20):
            act.on_transition(transition(at=float(i)))
            act.on_transition(transition(to="resolved", frm="firing",
                                         at=float(i)))
        return outcomes, act.factor()

    theirs, ours = both(run)
    assert ours == theirs
    assert ours[0].count("tightened") == 1 and ours[1] == 1.0


# ------------------------------------------- the loop's cadence signal


class FakeManager:
    """A checkpoint manager that records its saves (step, clock)."""

    process_count = 1

    def __init__(self, clock=None):
        self.fingerprint: dict = {}
        self.saves: list = []  # analysis: allow[py-unbounded-deque]
        self.clock = clock

    def restore_latest_valid(self, state, placements=None):
        return None

    def save_async(self, step, state):
        self.saves.append(step if self.clock is None else (step,
                                                           self.clock()))

    save = save_async

    def wait(self):
        pass


def _run_loop(pkg, signal, **kw):
    clk = Clock()
    manager = FakeManager(clk)

    def step_fn(state, batch):
        clk.advance(100.0)
        return dict(state, step=state["step"] + 1), {}

    _, report = pkg["train"].run_with_checkpointing(
        step_fn, {"step": 0}, [{"x": [1]} for _ in range(20)], manager,
        save_every_s=1000.0, cadence_signal=signal,
        install_signal_handler=False, clock=clk, **kw)
    return manager.saves, vars(report)


def _boom():
    raise RuntimeError("signal source gone")


@pytest.mark.parametrize("name,signal", [
    ("normal", lambda: 1.0), ("tightened", lambda: 0.25),
    ("broken", _boom), ("out_of_range", lambda: 7.0),
    ("negative", lambda: -1.0)])
def test_loop_cadence_signal_matches_the_reference(name, signal):
    theirs, ours = both(lambda pkg: _run_loop(pkg, signal))
    assert ours == theirs
    saves, report = ours
    assert report["final_step"] == 20
    normal, _ = _run_loop(PACKAGES["port"], lambda: 1.0)
    if name == "tightened":
        # 2000 s of steps: the 1000 s cadence tightened to 250 s.
        assert len(saves) > len(normal)
        gap = min(b - a for (_, a), (_, b) in zip(saves, saves[1:]))
        assert gap < min(b - a for (_, a), (_, b) in zip(normal, normal[1:]))
    else:
        assert saves == normal


def test_step_cadence_tightens_through_the_factor():
    def run(pkg):
        manager = FakeManager()
        pkg["train"].run_with_checkpointing(
            lambda state, batch: (dict(state, step=state["step"] + 1), {}),
            {"step": 0}, [{"x": [1]}] * 16, manager, save_every_steps=8,
            cadence_signal=lambda: 0.25, install_signal_handler=False,
            clock=Clock())
        return manager.saves

    theirs, ours = both(run)
    assert ours == theirs == [2, 4, 6, 8, 10, 12, 14, 16]


def test_the_signal_rides_the_agreed_token_on_many_processes():
    """With several processes the factor is read only for process 0's
    view, which is broadcast: every boundary consults the broadcast."""
    def run(pkg):
        agreed = []

        class Manager(FakeManager):
            process_count = 2

            def broadcast_from_zero(self, key, token):
                agreed.append((key, token))
                return token

        manager = Manager()
        pkg["train"].run_with_checkpointing(
            lambda state, batch: (dict(state, step=state["step"] + 1), {}),
            {"step": 0}, [{"x": [1]}] * 6, manager, save_every_steps=8,
            cadence_signal=lambda: 0.25, install_signal_handler=False,
            clock=Clock())
        return manager.saves, agreed

    theirs, ours = both(run)
    assert ours == theirs
    assert ours[0] == [2, 4, 6] and len(ours[1]) == 7


# ------------------------------------------------------------ telemetry


def test_run_steps_feeds_telemetry_per_step_like_the_reference():
    def run(pkg):
        def fake_step(state, batch):
            return state + 1, {"loss": np.float32(0.5)}

        meter = pkg["telemetry"](flops_per_example=1e6, device_kind="cpu")
        batches = [{"image": np.zeros((4, 2, 2, 3))} for _ in range(3)]
        state, metrics = pkg["train"].run_steps(fake_step, 0, batches,
                                                telemetry=meter)
        keep = ("kind", "step", "batch_size", "flops_per_example", "device")
        return state, [{k: r[k] for k in keep} for r in meter.records]

    theirs, ours = both(run)
    assert ours == theirs
    assert ours[0] == 3 and [r["step"] for r in ours[1]] == [0, 1, 2]


def counting_step(state, batch):
    return ({"w": state["w"] + batch["x"], "step": state["step"] + 1},
            {"loss": np.float32(0.0)})


def test_profiler_recorder_and_telemetry_stamp_like_the_reference(tmp_path):
    def run(pkg):
        root = tmp_path / pkg["train"].__name__
        prof = pkg["profiler"](memory=False)
        rec = pkg["recorder"](capacity=32, dump_dir=str(root / "dumps"))
        meter = pkg["telemetry"](flops_per_example=1e6, device_kind="cpu")
        manager = pkg["ckpt"].CheckpointManager(root / "ckpt", keep=5)
        _, report = pkg["train"].run_with_checkpointing(
            counting_step, {"w": np.zeros(4, np.float32),
                            "step": np.int32(0)},
            [{"x": np.ones(4, np.float32)} for _ in range(6)], manager,
            save_every_steps=4, telemetry=meter, profiler=prof,
            recorder=rec, install_signal_handler=False)
        digest = prof.snapshot()
        steps = [s for s in rec.snapshots() if s["kind"] == "train_step"]
        return (vars(report),
                {name: d["count"] for name, d in digest.items()},
                [sorted(s["phases"]) for s in steps],
                [s["memory"] for s in steps],
                [sorted(r["phases"]) for r in meter.records])

    theirs, ours = both(run)
    assert ours == theirs
    report, counts, snapshot_phases, memory, record_phases = ours
    assert report["final_step"] == 6 and counts["step"] == 6
    assert counts["save"] >= 1 and counts["restore"] == 1
    assert len(snapshot_phases) == 6 and memory == [None] * 6
    assert len(record_phases) == 6 and all("step" in p for p in record_phases)


def test_goodput_and_publisher_through_the_loop_like_the_reference(tmp_path):
    """A preempted run and its resume, one meter carried across by
    snapshot: restore downtime, every step counted, publishes at the
    cadence saves and once at exit (rate limit off), each landing the
    meter's ratio on the CR to 4 places."""
    def run(pkg):
        api = FakeApiServer()
        api.create(_notebook())
        root = tmp_path / pkg["train"].__name__
        flushed = []

        class Publisher(pkg["fleet"].GoodputAnnotationPublisher):
            def flush(self, summary):
                flushed.append(summary["goodput_ratio"])
                super().flush(summary)

        publisher = Publisher(api, "user", "nb", min_interval_s=0.0)
        meter = pkg["goodput"]()
        kinds, reports = [], []
        for batches in (3, 2):
            manager = pkg["ckpt"].CheckpointManager(root, keep=5)
            _, report = pkg["train"].run_with_checkpointing(
                counting_step, {"w": np.zeros(4, np.float32),
                                "step": np.int32(0)},
                [{"x": np.ones(4, np.float32)}] * batches, manager,
                save_every_steps=2, goodput=meter,
                goodput_publish=publisher, install_signal_handler=False)
            reports.append(vars(report))
            kinds.append(sorted(meter.downtime_s))
            meter = pkg["goodput"].from_snapshot(meter.snapshot())
        annotation = api.get("kubeflow.org/v1beta1", "Notebook", "nb",
                             "user")["metadata"]["annotations"][
            pkg["fleet"].GOODPUT_ANNOTATION]
        return (reports, kinds, meter.steps, publisher.publishes,
                annotation == f"{flushed[-1]:.4f}" and 0 < flushed[-1] <= 1)

    theirs, ours = both(run)
    assert ours == theirs
    reports, kinds, steps, publishes, landed = ours
    assert reports[1]["resumed_from_step"] == 2 and steps == 5
    assert "restore" in kinds[1] and publishes == 4 and landed


def _notebook():
    return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {"name": "nb", "namespace": "user"}, "spec": {}}


def test_publisher_against_the_fake_api_server_matches_the_reference():
    def run(pkg):
        api, clk = FakeApiServer(), Clock()
        api.create(_notebook())
        publisher = pkg["fleet"].GoodputAnnotationPublisher(
            api, "user", "nb", min_interval_s=30.0, clock=clk)
        seen = []
        for at, ratio, final in ((0, 0.5, False), (10, 0.6, False),
                                 (11, 0.61234, True), (45, 0.7, False),
                                 (46, None, True)):
            clk.t = at
            call = publisher.flush if final else publisher
            call({"goodput_ratio": ratio} if ratio is not None else {})
            obj = api.get("kubeflow.org/v1beta1", "Notebook", "nb", "user")
            seen.append((obj["metadata"].get("annotations") or {}).get(
                pkg["fleet"].GOODPUT_ANNOTATION))
        broken = pkg["fleet"].GoodputAnnotationPublisher(
            object(), "user", "nb")
        broken({"goodput_ratio": 0.5})      # no patch_merge: logged only
        return seen, publisher.publishes, broken.publishes

    theirs, ours = both(run)
    assert ours == theirs
    assert ours == (["0.5000", "0.5000", "0.6123", "0.7000", "0.7000"], 3, 0)
    assert fleet.GOODPUT_ANNOTATION == ref_fleet.GOODPUT_ANNOTATION
    assert fleet.NOTEBOOK_API == ref_fleet.NOTEBOOK_API


# ---------------------------------------- goodput across a reshard


CFG = dict(vocab=256, layers=1, dim=128, heads=2)
SPEC_A = dict(dp=2, fsdp=2)


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, CFG["vocab"], (8, 16))


def _reference_reshard(root):
    """The reference's scenario on 4 and then 2 devices of its CPU mesh."""
    from kubeflow_tpu.models import (
        LMConfig,
        build_lm,
        create_lm_state,
        make_lm_train_step,
    )
    from kubeflow_tpu.parallel import MeshSpec, make_mesh, token_sharding

    goodput = ref_obs.GoodputMeter()
    reports = []
    spec_a = MeshSpec(**SPEC_A).resolve(4)
    for spec, seeds, key in ((spec_a, (0, 1, 2), 0),
                             (spec_a.refactor(2), (2, 3), 2)):
        mesh = make_mesh(spec, jax.devices()[:spec.n_devices])
        cfg = LMConfig(**CFG)
        state = create_lm_state(build_lm(cfg, mesh=mesh), jax.random.key(key),
                                (2, 16), mesh=mesh)
        manager = ref_ckpt.CheckpointManager(
            root, fingerprint={"mesh": list(spec.shape)})
        batches = [{"tokens": jax.device_put(
            jnp.asarray(_tokens(s), jnp.int32), token_sharding(mesh))}
            for s in seeds]
        _, report = ref_train.run_with_checkpointing(
            make_lm_train_step(mesh, cfg=cfg), state, batches, manager,
            save_every_steps=2, mesh=mesh, install_signal_handler=False,
            goodput=goodput)
        reports.append(vars(report))
    return reports, goodput


@pytest.fixture(scope="module")
def reshard(tmp_path_factory):
    root = tmp_path_factory.mktemp("goodput_reshard")
    spec_b = MeshSpec_refactored(2)
    world = torch_world.World(4, [("goodput_reshard", dict(
        root=str(root / "port"), spec_a=SPEC_A, spec_b=spec_b,
        ranks_b=[0, 1], cfg=CFG, batches_a=[_tokens(s) for s in (0, 1, 2)],
        batches_b=[_tokens(s) for s in (2, 3)]))],
        tmp_path_factory.mktemp("goodput_world"))
    want = _reference_reshard(root / "ref")
    return world.wait(), want


def MeshSpec_refactored(n):
    from kubeflow_tpu_torch.parallel import MeshSpec

    spec = MeshSpec(**SPEC_A).resolve(4).refactor(n)
    return dict(dp=spec.dp, fsdp=spec.fsdp, tp=spec.tp)


def test_goodput_across_a_reshard_matches_the_reference(reshard):
    results, (want_reports, want) = reshard
    outs = torch_world.outputs(results, "goodput_reshard")
    assert want_reports[1]["resharded"] and want_reports[1][
        "resumed_from_step"] == 2
    for rank, out in enumerate(outs):
        if rank < 2:        # ran both segments, as the reference's devices
            assert out["reports"] == want_reports
            assert set(out["goodput"]["downtime_s"]) == set(want.downtime_s)
            assert "reshard" in out["goodput"]["downtime_s"]
            assert out["goodput"]["steps"] == want.steps == 5
        else:               # left out of the refactored mesh
            assert out["reports"] == want_reports[:1]
            assert set(out["goodput"]["downtime_s"]) == {"restore"}
            assert out["goodput"]["steps"] == 3
        assert 0.0 < out["ratio"] <= 1.0
    assert 0.0 < want.goodput_ratio() <= 1.0

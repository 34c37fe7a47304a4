"""The port's checkpointing (``kubeflow_tpu_torch/models/checkpoint.py``)
and checkpointed train loop (``models/train.py``) against the JAX
package's, on the CPU.

Format: for the same LM train state, and for the same resnet18 state
(params, ``batch_stats`` and the SGD trace), each carried across with
``train_state_from_jax``, both packages write the same shard files, byte
for byte, so their per-shard digests agree; a checkpoint of either
package restores into the other bit for bit and both continue training
to equal losses (f32, 1e-5 absolute, as ``tests/test_torch_train.py``
holds a carried state). An fsdp-sharded JAX checkpoint (8 virtual CPU
devices) restores whole. An f32 → bf16 restore rounds as ``ml_dtypes``
does.

Behaviour: the cases follow ``tests/test_checkpoint.py``'s classes on
the port's manager and loop, with the chaos tier's kill points and
corruptions (``kubeflow_tpu.chaos.ckpt``, which work on the shared
format) and injected barrier/broadcast transports.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.chaos.ckpt import (
    CheckpointKiller,
    SimulatedCrash,
    drop_shard,
    flip_shard_bytes,
    truncate_shard,
)
from kubeflow_tpu.models import LMConfig as JConfig
from kubeflow_tpu.models import build_lm as jbuild_lm
from kubeflow_tpu.models import checkpoint as jckpt
from kubeflow_tpu.models import create_lm_state as jcreate_lm_state
from kubeflow_tpu.models import create_train_state as jcreate_train_state
from kubeflow_tpu.models import make_lm_train_step as jmake_step
from kubeflow_tpu.models import make_train_step as jmake_image_step
from kubeflow_tpu.models import resnet18 as jresnet18
from kubeflow_tpu_torch.models import checkpoint as ckpt
from kubeflow_tpu_torch.models import (
    LMConfig,
    build_lm,
    create_lm_state,
    create_train_state,
    make_lm_train_step,
    make_train_step,
    resnet18,
)
from kubeflow_tpu_torch.models.checkpoint import (
    ENV_CHECKPOINT_DIR,
    ENV_CHECKPOINT_EVERY_S,
    ENV_CHECKPOINT_EVERY_STEPS,
    ENV_CHECKPOINT_KEEP,
    MANIFEST_NAME,
    CheckpointCorrupt,
    CheckpointManager,
    cadence_from_env,
    latest_step,
    manager_from_env,
    restore_checkpoint,
    save_checkpoint,
)
from kubeflow_tpu_torch.models.convert import shard_state, train_state_from_jax
from kubeflow_tpu_torch.models.optim import flatten
from kubeflow_tpu_torch.models.transformer import LM_TP_RULES
from kubeflow_tpu_torch.obs.telemetry import GoodputMeter, StepTelemetry
from kubeflow_tpu_torch.parallel import Mesh, MeshSpec, Sharding
from kubeflow_tpu_torch.models.train import (
    RunReport,
    realign_batches,
    run_with_checkpointing,
)

SMALL = dict(vocab=64, layers=2, dim=32, heads=2)


def _lm_batches(seed, n, b=2, s=16):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SMALL["vocab"], (b, s)).astype(np.int32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def lm():
    """The JAX LM state after one step (mu and nu non-zero), its numpy
    copy, and the configs and steps of both sides."""
    jcfg = JConfig(dtype=jnp.float32, **SMALL)
    tcfg = LMConfig(dtype=torch.float32, **SMALL)
    jstate = jcreate_lm_state(jbuild_lm(jcfg, use_flash=False),
                              jax.random.key(0), (1, 16))
    jstep = jmake_step(cfg=jcfg)
    jstate, _ = jstep(jstate, {"tokens": jnp.asarray(_lm_batches(0, 1)[0])})
    return {"jcfg": jcfg, "tcfg": tcfg, "jstep": jstep,
            "tstep": make_lm_train_step(cfg=tcfg),
            "jstate_np": jax.tree.map(np.asarray, jstate)}


def _jstate(lm):
    """A fresh JAX state from the fixture's numpy copy (the JAX step
    donates its input)."""
    return jax.tree.map(jnp.asarray, lm["jstate_np"])


def _tstate(lm):
    return train_state_from_jax(lm["tcfg"], lm["jstate_np"], device="cpu")


def _jax_leaves(tree) -> dict[str, np.ndarray]:
    """keystr -> numpy for a JAX state (the reference's own keying)."""
    return {key: np.asarray(leaf) for key, leaf in
            jckpt._flatten_keys(jckpt._arrays_only(tree))}


def _port_leaves(state) -> dict[str, np.ndarray]:
    """keystr -> numpy for a port state, bf16 widened exactly to f32."""
    out = {}
    for key, leaf in ckpt._flatten_keys(ckpt._arrays_only(state)):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().float() if leaf.dtype == torch.bfloat16 \
                else leaf.detach()
            leaf = leaf.numpy()
        out[key] = np.asarray(leaf)
    return out


def _assert_same_state(port_state, jax_state):
    want = {k: v.astype(np.float32) if v.dtype.name == "bfloat16" else v
            for k, v in _jax_leaves(jax_state).items()}
    got = _port_leaves(port_state)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


def _three_steps(lm, jstate, tstate):
    jl, tl = [], []
    for tokens in _lm_batches(7, 3):
        jstate, jm = lm["jstep"](jstate, {"tokens": jnp.asarray(tokens)})
        tstate, tm = lm["tstep"](tstate,
                                 {"tokens": torch.from_numpy(tokens).long()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert tstate.step == int(jstate.step)


# ---------------------------------------------------------------------------
# format and cross-package restore
# ---------------------------------------------------------------------------


class TestFormat:
    def test_port_and_jax_write_the_same_shards(self, lm, tmp_path):
        jckpt.CheckpointManager(tmp_path / "jax").save(1, _jstate(lm))
        CheckpointManager(tmp_path / "port").save(1, _tstate(lm))
        for name in ("shard-00000.json", "shard-00000.bin"):
            assert ((tmp_path / "jax" / "1" / name).read_bytes()
                    == (tmp_path / "port" / "1" / name).read_bytes()), name
        meta = json.loads((tmp_path / "port" / "1" /
                           "shard-00000.json").read_text())
        keys = list(meta["leaves"])
        assert "['step']" in keys and "['opt_state'][0].count" in keys
        assert "['params']['block_0']['q_proj']['kernel']" in keys
        assert meta["leaves"]["['step']"] == {
            "dtype": "int32", "shape": [], "shards": [
                {"digest": meta["leaves"]["['step']"]["shards"][0]["digest"],
                 "index": [], "offset": meta["leaves"]["['step']"][
                     "shards"][0]["offset"], "size": 4}]}
        mu = meta["leaves"]["['opt_state'][0].mu['embed']['embedding']"]
        assert mu["dtype"] == "bfloat16" and mu["shape"] == [64, 32]
        files = [json.loads((tmp_path / side / "1" /
                             MANIFEST_NAME).read_text())["files"]
                 for side in ("jax", "port")]
        assert files[0] == files[1]

    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_checkpoint_restores_across_packages_and_trains_on(
            self, lm, tmp_path, direction):
        if direction == "jax_to_port":
            jckpt.save_checkpoint(tmp_path, _jstate(lm), step=1)
            like = create_lm_state(build_lm(lm["tcfg"]), seed=9,
                                   device="cpu")
            tstate = restore_checkpoint(tmp_path, like)
            assert tstate.tx is like.tx and tstate.apply_fn is like.apply_fn
            assert all(p.requires_grad for _, p in flatten(tstate.params))
            jstate = _jstate(lm)
        else:
            save_checkpoint(tmp_path, _tstate(lm), step=1)
            like = jcreate_lm_state(jbuild_lm(lm["jcfg"], use_flash=False),
                                    jax.random.key(9), (1, 16))
            jstate = jckpt.restore_checkpoint(tmp_path, like)
            tstate = _tstate(lm)
        _assert_same_state(tstate, jstate)
        _three_steps(lm, jstate, tstate)

    def test_fsdp_sharded_jax_checkpoint_restores_whole(self, tmp_path):
        """Leaves of 2^14 elements and more are fsdp-sharded in the
        reference (the embedding, up and down here): 4 shard entries per
        leaf, assembled whole."""
        from kubeflow_tpu.parallel import MeshSpec, make_mesh

        dims = dict(SMALL, vocab=256, dim=64)
        mesh = make_mesh(MeshSpec(dp=-1, fsdp=4), jax.devices()[:8])
        model = jbuild_lm(JConfig(dtype=jnp.float32, **dims), mesh=mesh)
        jstate = jcreate_lm_state(model, jax.random.key(3), (2, 16),
                                  mesh=mesh)
        jckpt.save_checkpoint(tmp_path, jstate, step=2)
        meta = json.loads((tmp_path / "2" / "shard-00000.json").read_text())
        assert max(len(v["shards"]) for v in meta["leaves"].values()) == 4
        like = create_lm_state(build_lm(LMConfig(**dims)), seed=1,
                               device="cpu")
        mgr = CheckpointManager(tmp_path)
        restored, step = mgr.restore_latest_valid(like)
        assert step == 2
        _assert_same_state(restored, jstate)
        # Saved from 8 virtual devices, restored on one process.
        assert mgr.metrics.restore_total == {"resumed_cross_topology": 1}
        assert mgr.last_restore["mismatch"]["device_count"]["saved"] == 8

    @pytest.mark.parametrize("template", ["torch", "numpy"])
    def test_f32_to_bf16_restore_rounds_as_ml_dtypes(self, tmp_path,
                                                     template):
        rng = np.random.default_rng(11)
        one = np.float32(1.0)
        ties = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8),
                         2 ** -130, 3.0e38, 65504.0], np.float32)
        values = np.concatenate([ties, (rng.normal(size=500) * 100).astype(
            np.float32), one * rng.uniform(-1, 1, 12).astype(np.float32)])
        save_checkpoint(tmp_path, {"w": values}, step=1)
        want = values.astype(ml_dtypes.bfloat16)
        if template == "torch":
            like = {"w": torch.zeros(values.shape, dtype=torch.bfloat16)}
            got = restore_checkpoint(tmp_path, like)["w"]
            assert got.dtype == torch.bfloat16
            got = got.view(torch.int16).numpy()
        else:
            like = {"w": np.zeros(values.shape, ml_dtypes.bfloat16)}
            got = restore_checkpoint(tmp_path, like)["w"]
            assert got.dtype == want.dtype
            got = got.view(np.int16)
        assert np.array_equal(got, want.view(np.int16))

    def test_metrics_render_as_the_reference_renders(self, tmp_path):
        from prometheus_client import generate_latest

        from kubeflow_tpu_torch.obs.exposition import render_text

        ref, port = jckpt.CheckpointMetrics(), ckpt.CheckpointMetrics()
        for metrics in (ref, port):
            for seconds, step in ((0.03, 2), (1.7, 4), (12.0, 6)):
                metrics.observe_save(seconds, step)
            for outcome in ("skipped_corrupt", "resumed", "skipped_corrupt"):
                metrics.observe_restore(outcome)

        def lines(text):
            return [line for line in text.decode().splitlines()
                    if "_created" not in line]

        assert lines(render_text(port.registry)) == lines(
            generate_latest(ref.registry))
        assert port.restore_total == ref.restore_total
        assert port.save_duration.count == 3
        assert port.last_committed_step == 6


# ---------------------------------------------------------------------------
# the manager (the reference's test classes, on the port)
# ---------------------------------------------------------------------------


def small_state(step: int, kind: str = "numpy"):
    state = {"w": np.arange(16, dtype=np.float32) + step,
             "b": np.full((2, 3), float(step), np.float32),
             "step": np.int32(step)}
    if kind == "torch":
        state["w"] = torch.from_numpy(state["w"])
        state["b"] = torch.from_numpy(state["b"])
    return state


def small_like():
    return {"w": np.zeros(16, np.float32), "b": np.zeros((2, 3), np.float32),
            "step": np.int32(0)}


# ---------------------------------------------------------------------------
# a resnet18 state: params, batch_stats and the SGD chain's trace
# ---------------------------------------------------------------------------


def _image_batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 8, size=(4,)))


@pytest.fixture(scope="module")
def image():
    """The reference's checkpoint fixture (``tests/test_checkpoint.py``
    ``trained_state``): a resnet18 of width 8 after one step, so the
    trace and the running averages have moved; f32 compute, so that a
    step after a restore compares tightly on both sides."""
    jmodel = jresnet18(num_classes=8, width=8, dtype=jnp.float32)
    jstate = jcreate_train_state(jmodel, jax.random.key(0), (2, 32, 32, 3))
    x, y = _image_batch(0)
    jstate, _ = jmake_image_step()(jstate, {"image": jnp.asarray(x),
                                            "label": jnp.asarray(y)})
    return {"jmodel": jmodel,
            "tmodel": resnet18(num_classes=8, width=8, dtype=torch.float32),
            "jstate_np": jax.tree.map(np.asarray, jstate)}


def _image_states(image):
    return (jax.tree.map(jnp.asarray, image["jstate_np"]),
            train_state_from_jax(image["tmodel"], image["jstate_np"],
                                 device="cpu"))


def _image_step_after(image, jstate, tstate):
    """One more step on both sides: equal losses (f32, 5e-5 absolute, as
    ``tests/test_torch_resnet.py`` holds a carried state)."""
    x, y = _image_batch(1)
    jstate, jm = jmake_image_step()(jstate, {"image": jnp.asarray(x),
                                             "label": jnp.asarray(y)})
    tstate, tm = make_train_step()(tstate, {"image": torch.from_numpy(x),
                                            "label": torch.from_numpy(y)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 5e-5
    assert tstate.step == int(jstate.step) == 2


class TestImageState:
    def test_port_and_jax_write_the_same_shards(self, image, tmp_path):
        jstate, tstate = _image_states(image)
        jckpt.CheckpointManager(tmp_path / "jax").save(1, jstate)
        CheckpointManager(tmp_path / "port").save(1, tstate)
        for name in ("shard-00000.json", "shard-00000.bin"):
            assert ((tmp_path / "jax" / "1" / name).read_bytes()
                    == (tmp_path / "port" / "1" / name).read_bytes()), name
        keys = list(json.loads((tmp_path / "port" / "1" /
                                "shard-00000.json").read_text())["leaves"])
        assert "['batch_stats']['norm_init']['mean']" in keys
        assert ("['opt_state'][1][0].trace['head']['kernel']" in keys)
        assert sum(".trace[" in k for k in keys) == 62
        files = [json.loads((tmp_path / side / "1" /
                             MANIFEST_NAME).read_text())["files"]
                 for side in ("jax", "port")]
        assert files[0] == files[1]

    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_checkpoint_restores_across_packages_and_trains_on(
            self, image, tmp_path, direction):
        jstate, tstate = _image_states(image)
        if direction == "jax_to_port":
            jckpt.save_checkpoint(tmp_path, jstate, step=1)
            like = create_train_state(image["tmodel"], seed=9,
                                      input_shape=(2, 32, 32, 3),
                                      device="cpu")
            tstate = restore_checkpoint(tmp_path, like)
            assert tstate.tx is like.tx and tstate.apply_fn is like.apply_fn
            assert all(p.requires_grad for _, p in flatten(tstate.params))
        else:
            save_checkpoint(tmp_path, tstate, step=1)
            like = jcreate_train_state(image["jmodel"], jax.random.key(9),
                                       (2, 32, 32, 3))
            jstate = jckpt.restore_checkpoint(tmp_path, like)
            tstate = _image_states(image)[1]
        _assert_same_state(tstate, jstate)
        _image_step_after(image, jstate, tstate)

    def test_port_roundtrip_restores_every_leaf(self, image, tmp_path):
        state = _image_states(image)[1]
        CheckpointManager(tmp_path).save(1, state)
        like = create_train_state(image["tmodel"], seed=3,
                                  input_shape=(2, 32, 32, 3), device="cpu")
        restored, step = CheckpointManager(tmp_path).restore_latest_valid(
            like)
        assert step == 1 and restored.step == 1
        want = dict(ckpt._flatten_keys(ckpt._arrays_only(state)))
        got = dict(ckpt._flatten_keys(ckpt._arrays_only(restored)))
        assert got.keys() == want.keys()
        for key, leaf in want.items():
            if isinstance(leaf, torch.Tensor):
                assert torch.equal(got[key], leaf), key
        assert restored.batch_stats is not like.batch_stats
        assert restored.opt_state[1][0].trace is not like.opt_state[1][0].trace


class TestCheckpoint:
    def test_roundtrip_single_device_and_stepped_layout(self, lm, tmp_path):
        state = _tstate(lm)
        save_checkpoint(tmp_path / "ckpt", state)
        like = create_lm_state(build_lm(lm["tcfg"]), seed=1, device="cpu")
        restored = restore_checkpoint(tmp_path / "ckpt", like)
        assert restored.step == 1 and restored.opt_state.count == 1
        for (path, a), (_, b) in zip(flatten(restored.params),
                                     flatten(state.params)):
            assert torch.equal(a, b), path
        assert restored.tx is like.tx
        save_checkpoint(tmp_path / "run", state, step=100)
        save_checkpoint(tmp_path / "run", state, step=250)
        assert latest_step(tmp_path / "run") == 250
        assert latest_step(tmp_path / "missing") is None

    def test_mesh_and_placements_name_a10(self, tmp_path):
        """Placements on a mesh (ROADMAP A10c, ported): four ranks of a
        dp=2 x fsdp=2 mesh (threads, a barrier between them) each write
        the blocks they hold as first replica, together one copy of the
        state; ranks of an fsdp=2 mesh read back their own regions, and a
        meshless restore reads every leaf whole."""
        want = small_state(7)
        mesh_a = [Mesh(MeshSpec(dp=2, fsdp=2).resolve(4), "cpu", {}, r)
                  for r in range(4)]
        barrier = threading.Barrier(4)
        errors = []

        def save(rank):
            mesh = mesh_a[rank]
            placements = {"w": Sharding(mesh, (("dp", "fsdp"),)),
                          "b": Sharding(mesh, ("dp", None)),
                          "step": Sharding(mesh, ())}
            blocks = {key: (value[tuple(slice(a, b) for a, b in
                                        placements[key].region(value.shape))]
                            if key != "step" else value)
                      for key, value in want.items()}
            try:
                CheckpointManager(tmp_path, process_id=rank, process_count=4,
                                  barrier=lambda: barrier.wait(30)).save(
                    7, blocks, placements=placements)
            # The assert below reports it.
            # analysis: allow[py-broad-except]
            except Exception as exc:
                errors.append(exc)

        threads = [threading.Thread(target=save, args=(r,)) for r in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors
        sizes = [os.path.getsize(tmp_path / "7" / f"shard-{r:05d}.bin")
                 for r in range(4)]
        assert sum(sizes) == 16 * 4 + 6 * 4 + 4
        assert sizes == [4 * 4 + 3 * 4 + 4, 4 * 4, 4 * 4 + 3 * 4, 4 * 4]
        for rank in range(2):
            mesh = Mesh(MeshSpec(dp=1, fsdp=2).resolve(2), "cpu", {}, rank)
            got = CheckpointManager(tmp_path).restore(7, small_like(), {
                "w": Sharding(mesh, ("fsdp",)), "b": Sharding(mesh, ()),
                "step": Sharding(mesh, ())})
            np.testing.assert_array_equal(got["w"],
                                          want["w"][8 * rank:8 * rank + 8])
            np.testing.assert_array_equal(got["b"], want["b"])
            assert int(got["step"]) == 7
        whole = restore_checkpoint(tmp_path, small_like())
        for key, value in want.items():
            np.testing.assert_array_equal(whole[key], value)


class TestCrossTopologyFingerprint:
    def test_tuple_fingerprint_extras_do_not_fake_a_mismatch(self, tmp_path):
        """Extras cross JSON on the way to disk (tuples become lists): a
        manager built with ``{"mesh": spec.shape}`` (a tuple) still
        classifies an identical-topology restore as plain ``resumed``."""
        spec = MeshSpec(dp=-1, fsdp=2).resolve(8)
        CheckpointManager(tmp_path, fingerprint={"mesh": spec.shape}).save(
            10, small_state(10))
        metrics = ckpt.CheckpointMetrics()
        reader = CheckpointManager(tmp_path, metrics=metrics,
                                   fingerprint={"mesh": spec.shape})
        _state, step = reader.restore_latest_valid(small_like())
        assert step == 10 and metrics.restore_total == {"resumed": 1}
        assert reader.last_restore["cross_topology"] is False

    def test_another_mesh_shape_is_cross_topology(self, tmp_path):
        CheckpointManager(tmp_path, fingerprint={"mesh": [8, 1, 1, 1, 1, 1]}
                          ).save(10, small_state(10))
        metrics = ckpt.CheckpointMetrics()
        reader = CheckpointManager(tmp_path, metrics=metrics,
                                   fingerprint={"mesh": [4, 1, 2, 1, 1, 1]})
        reader.restore_latest_valid(small_like())
        assert metrics.restore_total == {"resumed_cross_topology": 1}
        assert list(reader.last_restore["mismatch"]) == ["mesh"]


class TestManagerAtomicity:
    @pytest.mark.parametrize(
        "point", ["shard_written", "pre_manifest", "manifest_written"])
    def test_kill_before_commit_preserves_previous_step(self, tmp_path,
                                                        point):
        CheckpointManager(tmp_path).save(3, small_state(3))
        killer = CheckpointKiller(point)
        mgr = CheckpointManager(tmp_path, hook=killer)
        with pytest.raises(SimulatedCrash):
            mgr.save(5, small_state(5))
        assert killer.fired and mgr.steps() == [3]
        state, step = mgr.restore_latest_valid(small_like())
        assert step == 3 and np.array_equal(state["w"], small_state(3)["w"])
        assert any(n.startswith("_tmp.") for n in os.listdir(tmp_path))
        CheckpointManager(tmp_path).save(6, small_state(6))
        assert not any(n.startswith("_tmp.") for n in os.listdir(tmp_path))

    def test_stale_tmp_from_bigger_world_does_not_wedge(self, tmp_path):
        dead = CheckpointManager(tmp_path, process_id=0, process_count=2,
                                 barrier=lambda: None,
                                 hook=CheckpointKiller("pre_manifest"))
        with pytest.raises(SimulatedCrash):
            dead.save(7, small_state(7))
        tmp = tmp_path / "_tmp.7"
        (tmp / "shard-00001.bin").write_bytes(b"stale payload")
        (tmp / "shard-00001.json").write_text("{}")
        mgr = CheckpointManager(tmp_path)
        mgr.save(7, small_state(7))
        state, step = mgr.restore_latest_valid(small_like())
        assert step == 7 and np.array_equal(state["w"], small_state(7)["w"])
        assert "shard-00001.bin" not in os.listdir(tmp_path / "7")

    def test_kill_after_commit_is_a_complete_step(self, tmp_path):
        mgr = CheckpointManager(tmp_path, hook=CheckpointKiller("committed"))
        with pytest.raises(SimulatedCrash):
            mgr.save(4, small_state(4))
        mgr2 = CheckpointManager(tmp_path)
        assert mgr2.steps() == [4] and mgr2.validate(4) == []
        assert mgr2.restore_latest_valid(small_like())[1] == 4

    def test_async_save_error_surfaces_on_wait(self, tmp_path):
        mgr = CheckpointManager(tmp_path,
                                hook=CheckpointKiller("pre_manifest"))
        mgr.save_async(2, small_state(2))
        with pytest.raises(SimulatedCrash):
            mgr.wait()
        assert isinstance(mgr.last_error, SimulatedCrash)

    def test_double_buffered_saves_commit_in_order(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=10)
        for step in (1, 2, 3):
            mgr.save_async(step, small_state(step))
        mgr.wait()
        assert mgr.steps() == [1, 2, 3]
        state, step = mgr.restore_latest_valid(small_like())
        assert step == 3 and np.array_equal(state["b"], small_state(3)["b"])

    @pytest.mark.parametrize("kind", ["numpy", "torch"])
    def test_snapshot_survives_caller_mutation_after_save_async(
            self, tmp_path, kind):
        """The port's step writes its tensors in place right after a
        save_async returns: the snapshot must be a copy."""
        mgr = CheckpointManager(tmp_path, keep=10)
        state = small_state(1, kind)
        mgr.save_async(1, state)
        state["w"][:] = -777.0
        state["b"][:] = -777.0
        mgr.wait()
        restored, step = mgr.restore_latest_valid(small_like())
        assert step == 1
        assert np.array_equal(restored["w"], small_state(1)["w"])
        assert np.array_equal(restored["b"], small_state(1)["b"])

    def test_only_process_zero_snapshots_bytes(self, lm):
        """Ranks other than 0 write no payload: their snapshot carries
        each leaf's key, shape and dtype as process 0's does, and no
        copy."""
        state = _tstate(lm)
        zero = ckpt._snapshot(state, 0)
        other = ckpt._snapshot(state, 1)
        assert [(h.key, h.shape, h.dtype) for h in other] == [
            (h.key, h.shape, h.dtype) for h in zero]
        assert "bfloat16" in {h.dtype for h in zero}
        assert all(len(h.shards) == 1 for h in zero)
        assert all(h.shards == [] for h in other)


class TestCorruptionFallback:
    def _two_steps(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=10)
        mgr.save(10, small_state(10))
        mgr.save(20, small_state(20))
        return mgr

    @pytest.mark.parametrize("damage",
                             [truncate_shard, drop_shard, flip_shard_bytes])
    def test_damaged_newest_step_falls_back(self, tmp_path, damage):
        mgr = self._two_steps(tmp_path)
        damage(tmp_path, 20)
        state, step = mgr.restore_latest_valid(small_like())
        assert step == 10 and np.array_equal(state["w"],
                                             small_state(10)["w"])
        assert mgr.metrics.restore_total == {"skipped_corrupt": 1,
                                             "resumed": 1}

    def test_all_steps_corrupt_returns_none(self, tmp_path):
        mgr = self._two_steps(tmp_path)
        truncate_shard(tmp_path, 10)
        drop_shard(tmp_path, 20)
        assert mgr.restore_latest_valid(small_like()) is None
        assert mgr.metrics.restore_total == {"skipped_corrupt": 2, "none": 1}

    def test_manifest_garbage_is_torn_not_fatal(self, tmp_path):
        mgr = self._two_steps(tmp_path)
        (tmp_path / "20" / MANIFEST_NAME).write_text("{not json")
        assert mgr.restore_latest_valid(small_like())[1] == 10

    def test_validate_reports_problems(self, tmp_path):
        mgr = self._two_steps(tmp_path)
        assert mgr.validate(20) == []
        drop_shard(tmp_path, 20)
        problems = mgr.validate(20)
        assert problems and "missing" in problems[0]
        with pytest.raises(CheckpointCorrupt):
            mgr.restore(20, small_like())


class TestRetentionGC:
    def test_keep_bounds_committed_steps(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=3)
        for step in range(1, 8):
            mgr.save(step, small_state(step))
        assert mgr.steps() == [5, 6, 7]

    def test_failed_save_never_gcs_good_steps(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2)
        mgr.save(1, small_state(1))
        mgr.save(2, small_state(2))
        broken = CheckpointManager(tmp_path, keep=2,
                                   hook=CheckpointKiller("pre_manifest"))
        with pytest.raises(SimulatedCrash):
            broken.save(3, small_state(3))
        assert broken.steps() == [1, 2]

    def test_save_metrics_recorded(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(9, small_state(9))
        assert mgr.metrics.last_committed_step == 9
        assert mgr.metrics.save_duration.count == 1


class TestLatestStepHardening:
    def test_junk_entries_ignored(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(42, small_state(42))
        os.makedirs(tmp_path / "_tmp.99")
        (tmp_path / "777").write_text("not a step dir")
        os.makedirs(tmp_path / "logs")
        (tmp_path / "notes.txt").write_text("x")
        assert latest_step(tmp_path) == 42 and mgr.steps() == [42]

    def test_missing_and_file_paths(self, tmp_path):
        assert latest_step(tmp_path / "missing") is None
        target = tmp_path / "afile"
        target.write_text("x")
        assert latest_step(target) is None

    def test_torn_numeric_dir_is_not_committed(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(5, small_state(5))
        os.makedirs(tmp_path / "9")  # numeric dir, no manifest
        assert mgr.steps() == [5] and mgr.latest_committed_step() == 5
        assert latest_step(tmp_path) == 9
        assert mgr.restore_latest_valid(small_like())[1] == 5


# ---------------------------------------------------------------------------
# train loop: auto-resume, cadence, SIGTERM grace window
# ---------------------------------------------------------------------------


def counting_step(state, batch):
    return ({"w": state["w"] + batch["x"], "step": state["step"] + 1},
            {"loss": np.float32(0.0)})


def ones_batches(n):
    return [{"x": np.ones(4, np.float32)} for _ in range(n)]


def fresh_state():
    return {"w": np.zeros(4, np.float32), "step": np.int32(0)}


class TestRunWithCheckpointing:
    def test_step_cadence_and_resume(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=10)
        _, report = run_with_checkpointing(
            counting_step, fresh_state(), ones_batches(12), mgr,
            save_every_steps=5, install_signal_handler=False)
        assert report.final_step == 12 and report.saves == 2
        assert mgr.steps() == [5, 10]
        mgr2 = CheckpointManager(tmp_path, keep=10)
        state, report = run_with_checkpointing(
            counting_step, fresh_state(), ones_batches(2), mgr2,
            save_every_steps=5, install_signal_handler=False)
        assert report.resumed_from_step == 10
        assert report.start_step == 10 and report.final_step == 12
        assert state["w"][0] == 12.0
        assert mgr2.metrics.restore_total["resumed"] == 1

    def test_realign_batches_resumes_at_right_example(self, tmp_path):
        def seeded_batches(n=20):
            for i in range(n):
                yield {"x": np.full(4, float(i + 1), np.float32)}

        mgr = CheckpointManager(tmp_path, keep=10)
        run_with_checkpointing(
            counting_step, fresh_state(),
            itertools.islice(seeded_batches(), 7), mgr,
            save_every_steps=5, install_signal_handler=False)
        assert mgr.steps() == [5]
        seen: list[float] = []

        def spy(batches):
            for batch in batches:
                seen.append(float(batch["x"][0]))
                yield batch

        batches = realign_batches(seeded_batches(), RunReport(start_step=5))
        _, report2 = run_with_checkpointing(
            counting_step, fresh_state(), spy(batches),
            CheckpointManager(tmp_path, keep=10),
            install_signal_handler=False)
        assert report2.start_step == 5 and seen[0] == 6.0
        it = realign_batches(seeded_batches(3), 2)
        assert float(next(it)["x"][0]) == 3.0
        with pytest.raises(ValueError, match="ran dry"):
            realign_batches(seeded_batches(3), 5)
        assert list(realign_batches(seeded_batches(3), 5,
                                    strict=False)) == []

    def test_wall_clock_cadence(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=10)
        now = [0.0]

        def clock():
            now[0] += 10.0  # every step "takes" 10s
            return now[0]

        _, report = run_with_checkpointing(
            counting_step, fresh_state(), ones_batches(6), mgr,
            save_every_s=25.0, clock=clock, install_signal_handler=False)
        assert report.saves >= 2
        assert mgr.latest_committed_step() is not None

    def test_sigterm_takes_final_synchronous_checkpoint(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=10)

        def batches():
            for i in range(1000):
                if i == 7:  # preemption arrives mid-training
                    os.kill(os.getpid(), signal.SIGTERM)
                yield {"x": np.ones(4, np.float32)}

        previous = signal.getsignal(signal.SIGTERM)
        state, report = run_with_checkpointing(
            counting_step, fresh_state(), batches(), mgr,
            save_every_steps=100)
        assert report.preempted and report.final_step == 8
        assert mgr.latest_committed_step() == report.final_step
        assert np.array_equal(
            mgr.restore_latest_valid(fresh_state())[0]["w"], state["w"])
        assert signal.getsignal(signal.SIGTERM) == previous

    def test_signal_handler_only_from_the_main_thread(self, tmp_path):
        previous = signal.getsignal(signal.SIGTERM)
        out = {}

        def run():
            out["report"] = run_with_checkpointing(
                counting_step, fresh_state(), ones_batches(3),
                CheckpointManager(tmp_path))[1]

        worker = threading.Thread(target=run)
        worker.start()
        worker.join()
        assert out["report"].final_step == 3
        assert signal.getsignal(signal.SIGTERM) == previous

    def test_resume_skips_torn_step(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=10)
        run_with_checkpointing(counting_step, fresh_state(),
                               ones_batches(10), mgr, save_every_steps=5,
                               install_signal_handler=False)
        truncate_shard(tmp_path, 10)
        _, report = run_with_checkpointing(
            counting_step, fresh_state(), ones_batches(1),
            CheckpointManager(tmp_path, keep=10), save_every_steps=5,
            install_signal_handler=False)
        assert report.resumed_from_step == 5

    def test_trainstate_roundtrip_through_loop(self, lm, tmp_path):
        """The port's LM step (in place) with a save after every step,
        then a resume into a fresh template: bit-equal state, and the
        phase profiler and flight recorder see every step."""
        from kubeflow_tpu_torch.obs import FlightRecorder, PhaseProfiler

        state = create_lm_state(build_lm(lm["tcfg"]), seed=0, device="cpu")
        batches = [{"tokens": torch.from_numpy(t).long()}
                   for t in _lm_batches(3, 3)]
        mgr = CheckpointManager(tmp_path, keep=10)
        profiler, recorder = PhaseProfiler(memory=False), FlightRecorder()
        trained, report = run_with_checkpointing(
            lm["tstep"], state, batches, mgr, save_every_steps=1,
            install_signal_handler=False, profiler=profiler,
            recorder=recorder)
        assert report.final_step == 3 and mgr.steps() == [1, 2, 3]
        assert profiler.snapshot()["step"]["count"] == 3
        assert [s["step"] for s in recorder.snapshots()] == [1, 2, 3]
        like = create_lm_state(build_lm(lm["tcfg"]), seed=1, device="cpu")
        resumed, report2 = run_with_checkpointing(
            lm["tstep"], like, [], CheckpointManager(tmp_path, keep=10),
            install_signal_handler=False)
        assert report2.resumed_from_step == 3 and resumed.step == 3
        assert _port_leaves(resumed).keys() == _port_leaves(trained).keys()
        for key, value in _port_leaves(trained).items():
            assert np.array_equal(_port_leaves(resumed)[key], value), key

    def test_mesh_run_stamps_its_mesh_and_resumes_on_it(self, tmp_path, lm):
        """``run_with_checkpointing(mesh=, tp_rules=)`` (ROADMAP A10c,
        ported) lays a whole state onto a mesh of one rank, saves its
        blocks with the mesh's shape in the fingerprint, and resumes on
        the same mesh bit for bit, not cross-topology."""
        mesh = Mesh(MeshSpec().resolve(1), torch.device("cpu"), {}, 0)

        def nudge(state, batch):
            with torch.no_grad():
                for _, p in flatten(state.params):
                    p.add_(batch)
            state.step += 1
            return state, {"loss": torch.zeros(())}

        state, report = run_with_checkpointing(
            nudge, _tstate(lm), [0.5, 0.25, 0.125], CheckpointManager(
                tmp_path, keep=10), save_every_steps=2, mesh=mesh,
            tp_rules=LM_TP_RULES, install_signal_handler=False)
        assert state.mesh is mesh and report.final_step == 4
        manager = CheckpointManager(tmp_path, keep=10)
        assert manager.steps() == [2, 4]
        assert manager.step_fingerprint(4)["mesh"] == [1, 1, 1, 1, 1, 1]
        resumed, report2 = run_with_checkpointing(
            nudge, _tstate(lm), [], manager, mesh=mesh,
            install_signal_handler=False)
        assert report2.resumed_from_step == 4 and not report2.resharded
        assert resumed.mesh is mesh
        for key, value in _port_leaves(state).items():
            assert np.array_equal(_port_leaves(resumed)[key], value), key

    @pytest.mark.parametrize("fault", ["other_mesh", "manager_world"])
    def test_mesh_run_refuses_a_state_or_manager_off_its_mesh(
            self, tmp_path, lm, fault):
        """A state on another mesh, or a manager that does not span the
        mesh's ranks (its shard files would collide), is refused."""
        spec = MeshSpec(dp=2).resolve(2)
        mesh, other = (Mesh(spec, torch.device("cpu"), {}, 0)
                       for _ in range(2))
        state = _tstate(lm)
        if fault == "other_mesh":
            state = shard_state(state, other)
        with pytest.raises(ValueError, match="mesh|process_count"):
            run_with_checkpointing(counting_step, state, [],
                                   CheckpointManager(tmp_path), mesh=mesh,
                                   install_signal_handler=False)

    @pytest.mark.parametrize("kwarg,item", [
        ("telemetry", "A11"), ("goodput", "A11"), ("goodput_publish", "A11"),
        ("cadence_signal", "A5 leftovers")])
    def test_unported_collaborators_name_their_roadmap_item(
            self, tmp_path, kwarg, item):
        """The collaborators the loop refused until the hooks were ported
        (the roadmap item each was queued under) take effect: telemetry
        observes each step, goodput counts them and the restore,
        the publisher lands at the cadence save and at exit, and the
        cadence signal tightens an 8-step cadence to every 2 steps."""
        published = []

        class Publisher:
            def __call__(self, summary):
                published.append(("cadence", summary["steps"]))

            def flush(self, summary):
                published.append(("exit", summary["steps"]))

        hooks = {
            "telemetry": StepTelemetry(flops_per_example=1e6,
                                       device_kind="cpu"),
            "goodput": GoodputMeter(),
            "goodput_publish": Publisher(),
            "cadence_signal": lambda: 0.25,
        }
        kwargs = {kwarg: hooks[kwarg]}
        if kwarg == "goodput_publish":
            kwargs["goodput"] = hooks["goodput"]
        _, report = run_with_checkpointing(
            counting_step, fresh_state(), ones_batches(4),
            CheckpointManager(tmp_path, keep=10), save_every_steps=8,
            install_signal_handler=False, **kwargs)
        assert report.final_step == 4
        if kwarg == "telemetry":
            assert [r["step"] for r in hooks["telemetry"].records] == [
                0, 1, 2, 3]
        if kwarg in ("goodput", "goodput_publish"):
            assert hooks["goodput"].steps == 4
            assert set(hooks["goodput"].downtime_s) == {"restore"}
        if kwarg == "goodput_publish":
            assert published == [("exit", 4)]   # no cadence save in 4
        if kwarg == "cadence_signal":
            assert report.saves == 2
            assert CheckpointManager(tmp_path).steps() == [2, 4]
        else:
            assert report.saves == 0


class TestEnvPlumbing:
    def test_cadence_from_env(self):
        env = {ENV_CHECKPOINT_EVERY_STEPS: "50",
               ENV_CHECKPOINT_EVERY_S: "12.5"}
        assert cadence_from_env(env) == (50, 12.5)
        assert cadence_from_env({}) == (0, 0.0)
        assert cadence_from_env(
            {ENV_CHECKPOINT_EVERY_STEPS: "garbage"}) == (0, 0.0)

    def test_manager_from_env(self, tmp_path):
        assert manager_from_env({}) is None
        mgr = manager_from_env({ENV_CHECKPOINT_DIR: str(tmp_path),
                                ENV_CHECKPOINT_KEEP: "5"})
        assert mgr.directory == str(tmp_path) and mgr.keep == 5
        assert (mgr.process_id, mgr.process_count) == (0, 1)

    def test_webhook_poddefault_carries_the_contract(self):
        from kubeflow_tpu.webhook.server import tpu_env_poddefault

        env = {e["name"]: e["value"]
               for e in tpu_env_poddefault("user")["spec"]["env"]}
        names = (ENV_CHECKPOINT_DIR, ENV_CHECKPOINT_EVERY_STEPS,
                 ENV_CHECKPOINT_EVERY_S, ENV_CHECKPOINT_KEEP)
        assert names == (jckpt.ENV_CHECKPOINT_DIR,
                         jckpt.ENV_CHECKPOINT_EVERY_STEPS,
                         jckpt.ENV_CHECKPOINT_EVERY_S,
                         jckpt.ENV_CHECKPOINT_KEEP)
        assert all(name in env for name in names[:3])
        steps, secs = cadence_from_env(env)
        assert steps > 0 and secs > 0
        assert (ckpt.MANIFEST_NAME, ckpt.TMP_PREFIX, ckpt.MANIFEST_FORMAT
                ) == (jckpt.MANIFEST_NAME, jckpt.TMP_PREFIX,
                      jckpt.MANIFEST_FORMAT)


# ---------------------------------------------------------------------------
# multi-process coordination: step-keyed barriers, broadcast agreement
# ---------------------------------------------------------------------------


class RecordingClient:
    """In-memory coordination client: barriers record their ids, kv keys
    are write-once."""

    def __init__(self):
        # analysis: allow[py-unbounded-deque] — test double, bounded by the test's save count
        self.barriers = []
        self.kv = {}

    def wait_at_barrier(self, name, timeout_in_ms=None):
        self.barriers.append(name)

    def key_value_set(self, key, value):
        assert key not in self.kv, f"kv key reused: {key}"
        self.kv[key] = value

    def blocking_key_value_get(self, key, timeout_in_ms):
        assert key in self.kv, f"kv key never published: {key}"
        return self.kv[key]

    def key_value_delete(self, key):
        self.kv.pop(key, None)


class PeerForger:
    """Hook that fabricates process 1's shard files once process 0's are
    durable, so a ``process_count=2`` manager runs the whole protocol in
    one test process."""

    def __init__(self, inner=None):
        self.manager = None
        self.inner = inner

    def __call__(self, point, info):
        if point == "pre_manifest":
            tmp = self.manager._tmp_dir(info["step"])
            with open(os.path.join(tmp, "shard-00000.bin"), "rb") as fh:
                payload = fh.read()
            with open(os.path.join(tmp, "shard-00001.bin"), "wb") as fh:
                fh.write(payload)
            with open(os.path.join(tmp, "shard-00000.json")) as fh:
                meta = json.load(fh)
            meta["process"] = 1
            with open(os.path.join(tmp, "shard-00001.json"), "w") as fh:
                fh.write(json.dumps(meta))
        if self.inner is not None:
            self.inner(point, info)


def forged_world_manager(tmp_path, inner_hook=None, **kwargs):
    forger = PeerForger(inner_hook)
    mgr = CheckpointManager(tmp_path, process_id=0, process_count=2,
                            hook=forger, **kwargs)
    forger.manager = mgr
    return mgr


class TestMultiHostCoordination:
    @pytest.fixture
    def client(self, monkeypatch):
        client = RecordingClient()
        monkeypatch.setattr(ckpt, "_coordination_client", lambda *_: client)
        return client

    def test_barrier_ids_derive_from_step_not_local_counter(self, tmp_path,
                                                            client):
        mgr = forged_world_manager(tmp_path, keep=10)
        ns = mgr._ns
        mgr.save(3, small_state(3))
        assert client.barriers == [f"kft-ckpt-{ns}-3.0-shards",
                                   f"kft-ckpt-{ns}-3.0-commit"]
        client.barriers.clear()
        mgr.save(3, small_state(3))
        assert client.barriers == [f"kft-ckpt-{ns}-3.1-shards",
                                   f"kft-ckpt-{ns}-3.1-commit"]

    def test_aborted_save_does_not_desync_later_barriers(self, tmp_path,
                                                         client):
        def die_pre_manifest(point, info):
            if point == "pre_manifest":
                raise SimulatedCrash("between the barriers")

        dying = forged_world_manager(tmp_path, inner_hook=die_pre_manifest,
                                     keep=10)
        ns = dying._ns
        with pytest.raises(SimulatedCrash):
            dying.save(5, small_state(5))
        assert client.barriers == [f"kft-ckpt-{ns}-5.0-shards"]
        client.barriers.clear()
        forged_world_manager(tmp_path, keep=10).save(6, small_state(6))
        assert client.barriers == [f"kft-ckpt-{ns}-6.0-shards",
                                   f"kft-ckpt-{ns}-6.0-commit"]

    def test_broadcast_from_zero_kv_roundtrip(self, tmp_path, client):
        p0 = CheckpointManager(tmp_path, process_id=0, process_count=2)
        p1 = CheckpointManager(tmp_path, process_id=1, process_count=2)
        assert p0.broadcast_from_zero("restore", "20") == "20"
        assert p1.broadcast_from_zero("restore", "") == "20"
        assert p0.broadcast_from_zero("restore", "10") == "10"
        assert p1.broadcast_from_zero("restore", "ignored") == "10"
        assert CheckpointManager(tmp_path).broadcast_from_zero("x",
                                                               "v") == "v"

    def test_restore_step_is_agreed_not_walked_per_process(self, tmp_path,
                                                           client):
        CheckpointManager(tmp_path, keep=10).save(10, small_state(10))
        CheckpointManager(tmp_path, keep=10).save(20, small_state(20))
        truncate_shard(tmp_path, 20)
        p0 = CheckpointManager(tmp_path, process_id=0, process_count=2)
        p1 = CheckpointManager(tmp_path, process_id=1, process_count=2)
        _, step0 = p0.restore_latest_valid(small_like())
        state1, step1 = p1.restore_latest_valid(small_like())
        assert step0 == step1 == 10
        assert np.array_equal(state1["w"], small_state(10)["w"])
        assert p0.metrics.restore_total.get("skipped_corrupt") == 1
        assert "skipped_corrupt" not in p1.metrics.restore_total
        assert p1.metrics.restore_total["resumed_cross_topology"] == 1
        assert "process_count" in p1.last_restore["mismatch"]
        assert p0.restore_latest_valid(small_like())[1] == 10
        drop_shard(tmp_path, 10)
        with pytest.raises(CheckpointCorrupt):
            p1.restore_latest_valid(small_like())

    def test_restore_none_is_agreed(self, tmp_path, client):
        p0 = CheckpointManager(tmp_path, process_id=0, process_count=2)
        p1 = CheckpointManager(tmp_path, process_id=1, process_count=2)
        assert p0.restore_latest_valid(small_like()) is None
        assert p1.restore_latest_valid(small_like()) is None
        assert p0.metrics.restore_total["none"] == 1
        assert p1.metrics.restore_total["none"] == 1

    def test_broadcast_keys_gcd_at_save_commit(self, tmp_path, client):
        mgr = forged_world_manager(tmp_path, keep=10)
        _, report = run_with_checkpointing(
            counting_step, fresh_state(), ones_batches(4), mgr,
            save_every_steps=4, save_every_s=1e9,
            install_signal_handler=False)
        assert report.saves == 1 and mgr.steps() == [4]
        assert client.kv == {}

    def test_broadcast_keys_gcd_periodically_without_saves(
            self, tmp_path, client, monkeypatch):
        monkeypatch.setattr(ckpt, "_BCAST_GC_EVERY", 4)
        mgr = CheckpointManager(tmp_path, process_id=0, process_count=2)
        for _ in range(10):
            mgr.broadcast_from_zero("cadence", "run")
        assert len(client.kv) <= 4
        assert [b for b in client.barriers if "bcast-gc" in b] == [
            f"kft-ckpt-{mgr._ns}-bcast-gc-4",
            f"kft-ckpt-{mgr._ns}-bcast-gc-8"]

    def test_multi_process_needs_a_transport(self, tmp_path):
        with pytest.raises(RuntimeError, match="transport"):
            CheckpointManager(tmp_path, process_id=1,
                              process_count=2).broadcast_from_zero("x", "")

    def test_torch_store_client_barrier_and_kv(self):
        """The transport over torch.distributed's store: two ranks meet
        at a barrier, and a value set by one is read by the other."""
        store = torch.distributed.HashStore()
        clients = [ckpt._StoreClient(store, 2) for _ in range(2)]
        passed = []

        def rank(i):
            clients[i].wait_at_barrier("b", 10_000)
            passed.append(i)

        threads = [threading.Thread(target=rank, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert sorted(passed) == [0, 1]
        clients[0].key_value_set("k", "20")
        assert clients[1].blocking_key_value_get("k", 10_000) == "20"
        clients[0].key_value_delete("k")
        assert not store.check(["k"])


class TestMultiHostCadence:
    def _manager(self, tmp_path, transport):
        return forged_world_manager(tmp_path, keep=10, barrier=lambda: None,
                                    broadcast=transport)

    def test_wall_clock_cadence_is_agreed_not_local(self, tmp_path):
        keys = []

        def transport(key, value):
            keys.append(key)
            return "save" if key.startswith("cadence-3.") else value

        mgr = self._manager(tmp_path, transport)
        _, report = run_with_checkpointing(
            counting_step, fresh_state(), ones_batches(5), mgr,
            save_every_s=1e9, install_signal_handler=False)
        assert mgr.steps() == [3] and report.saves == 1
        assert keys[0].startswith("restore.")
        assert [k.split(".")[0] for k in keys[1:]] == [
            f"cadence-{i}" for i in range(6)]

    @pytest.mark.parametrize("stop_at,batches", [(4, 100), (3, 3)],
                             ids=["mid_run", "after_last_consult"])
    def test_stop_is_agreed_and_final_save_synchronous(self, tmp_path,
                                                       stop_at, batches):
        def transport(key, value):
            return "stop" if key.startswith(f"cadence-{stop_at}.") else value

        mgr = self._manager(tmp_path, transport)
        _, report = run_with_checkpointing(
            counting_step, fresh_state(), ones_batches(batches), mgr,
            save_every_s=1e9, install_signal_handler=False)
        assert report.preempted and report.final_step == stop_at
        assert mgr.latest_committed_step() == stop_at


# A rank of a real two-process torch.distributed world (gloo on the
# CPU): cadence saves through the store's barriers, the agreed restore
# step, and a resumed second incarnation.
_RANK_SCRIPT = """
import json, sys
import numpy as np
import torch.distributed as dist
from kubeflow_tpu_torch.models.checkpoint import manager_from_env
from kubeflow_tpu_torch.models.train import run_with_checkpointing

rank, port, directory = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)

def step(state, batch):
    return ({"w": state["w"] + batch["x"], "step": state["step"] + 1},
            {"loss": np.float32(0.0)})

def run(n):
    mgr = manager_from_env({"KFT_CHECKPOINT_DIR": directory,
                            "KFT_CHECKPOINT_KEEP": "10"})
    state, report = run_with_checkpointing(
        step, {"w": np.zeros(4, np.float32), "step": np.int32(0)},
        [{"x": np.ones(4, np.float32)}] * n, mgr, save_every_steps=2,
        save_every_s=1e9, install_signal_handler=False)
    return mgr, state, report

mgr, _, first = run(5)
_, state, second = run(1)
print(json.dumps({"rank": mgr.process_id, "world": mgr.process_count,
                  "first": [first.final_step, first.saves],
                  "steps": mgr.steps(),
                  "resumed": second.resumed_from_step,
                  "w": float(state["w"][0])}))
dist.destroy_process_group()
"""


def test_two_process_world_agrees_through_the_torch_store(tmp_path):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(repo),
           "KFT_COORD_TIMEOUT_MS": "60000"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(rank), str(port),
         str(tmp_path)], cwd=repo, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for rank, out in enumerate(outs):
        assert out == {"rank": rank, "world": 2, "first": [5, 2],
                       "steps": [2, 4], "resumed": 4, "w": 5.0}, out
    manifest = json.loads((tmp_path / "4" / MANIFEST_NAME).read_text())
    assert sorted(manifest["files"]) == [
        "shard-00000.bin", "shard-00000.json", "shard-00001.bin",
        "shard-00001.json"]
    assert manifest["fingerprint"]["process_count"] == 2

"""Checkpoints on a mesh and fsdp's per-block gathers: the port
(``kubeflow_tpu_torch/models/{checkpoint,train,transformer}.py`` with
``parallel/{mesh,fsdp}.py``) against the JAX package on its 8-device
virtual CPU mesh.

One gloo world of 8 ranks (``tests/torch_world.py``) runs every case;
a mesh of some of its ranks (``make_mesh(ranks=)``, the reference's
``make_mesh(spec, jax.devices()[:n])``) stands in for a smaller slice.

Checkpoints, the reference's ``tests/test_checkpoint.py::
TestCrossTopologyRestore`` cases: the tiny LM (vocab 256, one layer, dim
128, 2 heads) trained one step on dp=4 x fsdp=2 and saved, then
restored on the refactored 4- and 2-rank meshes (each trains on), on
dp=1 x fsdp=4 x tp=2 (same world, another factoring), on the same mesh
(not cross-topology), into a template of another width (refused), and
into a whole template and from it onto a tp mesh; the loop resuming on a
refactored mesh and after a SIGTERM; the two-process restore; and both
directions across packages: a checkpoint the JAX package saved on its
mesh restores onto another port mesh, and one the port's world saved
restores in ``kubeflow_tpu`` on another JAX mesh. Every restore is held
bit for bit; the ranks' shard files together hold one copy of the state.

Per-block fsdp: fsdp=2 x sp=4 and dp=2 x fsdp=4 with packed rows whose
documents differ by rank (so their rings skip different hops while the
gathers and reduce-scatters run inside the backward): logits, loss,
gradients and the update against the reference's step on the same mesh,
with ``tests/test_torch_mesh_train.py``'s limits (logits 1e-4 absolute,
loss 1e-5 relative, gradients 1e-4 in relative norm), and each leaf's
update 1e-4 in relative norm under its f32 AdamW (``F32_ADAMW``: lr 0.1,
eps 1e-3, f32 moments, a first step smooth in the gradient); and no more than the embedding and two blocks' fsdp leaves whole at
once (``torch_world.WholeCount``). A hang fails the world's wait.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_world
from kubeflow_tpu.models import checkpoint as jckpt
from kubeflow_tpu.models.transformer import LM_TP_RULES as JLM_TP_RULES
from kubeflow_tpu.models.transformer import LMConfig as JLMConfig
from kubeflow_tpu.models.transformer import build_lm as jbuild_lm
from kubeflow_tpu.models.transformer import create_lm_state as jcreate_lm_state
from kubeflow_tpu.models.transformer import (
    make_lm_train_step as jmake_lm_train_step,
)
from kubeflow_tpu.parallel import MeshSpec as JMeshSpec
from kubeflow_tpu.parallel import make_mesh as jmake_mesh
from kubeflow_tpu_torch.models import LMConfig
from kubeflow_tpu_torch.models.checkpoint import (
    CheckpointManager,
    CheckpointMetrics,
)
from kubeflow_tpu_torch.models.transformer import is_moe_block, lm_placements
from kubeflow_tpu_torch.parallel import MeshSpec
from test_torch_mesh_train import (
    F32_ADAMW,
    GRAD_RTOL,
    LOGITS_ATOL,
    LOSS_RTOL,
    UPDATE_RTOL,
    _flat,
    _jax_lm_init,
    _jax_lm_refs,
    _logits,
    packed,
    update_errors,
)

CFG = dict(vocab=256, layers=1, dim=128, heads=2)
SPEC_A = dict(dp=4, fsdp=2)
BATCH = (8, 16)
RESTORES = ("shrink4", "shrink2", "relayout", "same", "whole")


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, CFG["vocab"], BATCH)


def _refactored(n):
    spec = MeshSpec(**SPEC_A).resolve(8).refactor(n)
    return dict(dp=spec.dp, fsdp=spec.fsdp, tp=spec.tp)


# name: (mesh spec, config, batch shape, packing seed)
# (dim 128: the embedding and every kernel reach the 2^14 elements that
# fsdp shards; 3 layers: a step that kept every block's gathered weights
# would hold more than two blocks' at once.)
FSDP_CASES = {
    "fsdp2_sp4_packed": (dict(dp=1, fsdp=2, sp=4),
                         dict(vocab=128, layers=3, dim=128, heads=2),
                         (4, 64), 11),
    "fsdp4_dp2_packed": (dict(dp=2, fsdp=4),
                         dict(vocab=128, layers=3, dim=128, heads=2),
                         (8, 64), 12),
}


def _jax_state_np(state) -> dict:
    """A JAX train state's array fields, whole, by keystr (bf16 widened)."""
    return {key: np.asarray(leaf, dtype=np.float32)
            if np.asarray(leaf).dtype.name == "bfloat16" else np.asarray(leaf)
            for key, leaf in jckpt._flatten_keys(jckpt._arrays_only(state))}


def _jax_trained(spec, seed):
    """The reference's tiny LM, one step on its mesh of ``spec``."""
    mesh = jmake_mesh(JMeshSpec(**spec))
    cfg = JLMConfig(**CFG)
    state = jcreate_lm_state(jbuild_lm(cfg, mesh=mesh), jax.random.key(seed),
                             (2, BATCH[1]), mesh=mesh)
    state, _ = jmake_lm_train_step(mesh, cfg=cfg)(
        state, {"tokens": jnp.asarray(_tokens(seed))})
    return state


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX checkpoint is written first; the world runs while the
    reference computes its fsdp steps."""
    root = tmp_path_factory.mktemp("mesh_ckpt")
    jstate = _jax_trained(SPEC_A, 3)
    jckpt.CheckpointManager(root / "from_jax").save(10, jstate)
    tasks = [
        ("ckpt_save:a", dict(root=str(root), dirs=RESTORES, spec=SPEC_A,
                             cfg=CFG, tokens=_tokens(0))),
        ("ckpt_restore:shrink4", dict(
            directory=str(root / "shrink4"), spec=_refactored(4), cfg=CFG,
            ranks=list(range(4)), tokens=_tokens(1))),
        ("ckpt_restore:shrink2", dict(
            directory=str(root / "shrink2"), spec=_refactored(2), cfg=CFG,
            ranks=[0, 1], tokens=_tokens(1))),
        ("ckpt_restore:relayout", dict(
            directory=str(root / "relayout"),
            spec=dict(dp=1, fsdp=4, tp=2), cfg=CFG)),
        ("ckpt_restore:same", dict(directory=str(root / "same"),
                                   spec=SPEC_A, cfg=CFG)),
        ("ckpt_refuse", dict(directory=str(root / "same"), spec=SPEC_A,
                             cfg=CFG)),
        ("ckpt_whole_and_onto", dict(directory=str(root / "whole"),
                                     spec=dict(dp=2, fsdp=2, tp=2), cfg=CFG,
                                     tokens=_tokens(5))),
        ("ckpt_restore:from_jax", dict(
            directory=str(root / "from_jax"), spec=dict(dp=2, fsdp=2, tp=2),
            cfg=CFG, tokens=_tokens(1))),
        ("ckpt_save:to_jax", dict(root=str(root), dirs=("to_jax",),
                                  spec=dict(dp=1, fsdp=4, sp=2), cfg=CFG,
                                  tokens=_tokens(4))),
        ("ckpt_two_process", dict(directory=str(root / "two"))),
        ("ckpt_loop:a", dict(root=str(root / "loop"), spec=SPEC_A, cfg=CFG,
                             batches=[_tokens(i) for i in range(3)])),
        ("ckpt_loop:b", dict(root=str(root / "loop"), spec=_refactored(4),
                             cfg=CFG, batches=[_tokens(i) for i in (2, 3)],
                             ranks=list(range(4)), seed=2)),
        ("ckpt_sigterm", dict(root=str(root / "sigterm"),
                              spec=dict(dp=2, fsdp=4), cfg=CFG,
                              batches=[_tokens(i) for i in range(4)],
                              stop_after=2)),
    ]
    pending, refs = {}, {}
    for name, (spec, cfg, shape, seed) in FSDP_CASES.items():
        rng = np.random.default_rng(len(name))
        tokens = rng.integers(0, cfg["vocab"], size=shape)
        seg = packed(*shape, seed=seed)
        jax_state, params, _ = _jax_lm_init(spec, cfg, shape[1],
                                            adamw=F32_ADAMW)
        pending[name] = (jax_state, tokens, seg, _flat(params))
        tasks.append((f"lm:{name}", dict(
            spec=spec, cfg=cfg, params=params, tokens=tokens,
            segment_ids=seg, forward_tokens=tokens, forward_segment_ids=seg,
            adamw=F32_ADAMW)))
    run = torch_world.World(8, tasks, tmp_path_factory.mktemp("ckpt_world"))
    for name, (jax_state, tokens, seg, before) in pending.items():
        refs[name] = _jax_lm_refs(*jax_state, tokens, seg, True)
        refs[name]["before"] = before
    return run.wait(timeout=900), refs, root, _jax_state_np(jstate)


def _members(results, name):
    return [out for out in torch_world.outputs(results, name)
            if out.get("member", True)]


def _assert_states_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _saved(results):
    return torch_world.outputs(results, "ckpt_save:a")[0]["state"]


# --------------------------------------------------------- the matrix


@pytest.mark.parametrize("name,ranks", [("shrink4", 4), ("shrink2", 2)])
def test_mesh_to_mesh_matrix(world, name, ranks):
    """8 -> 4 (the matrix's shrink row) and 8 -> 2 (fsdp absorbs what dp
    cannot): params and optimizer state bit-equal, sharded on the new
    mesh, classified cross-topology, and a step on from there."""
    results, _, _, _ = world
    outs = _members(results, f"ckpt_restore:{name}")
    assert len(outs) == ranks
    if ranks == 2:
        assert _refactored(2) == dict(dp=1, fsdp=2, tp=1)
    for out in outs:
        assert out["step"] == 10 and out["shapes_kept"]
        _assert_states_equal(out["state"], _saved(results))
        assert out["sharded"] > 0
        assert out["restore_total"] == {"resumed_cross_topology": 1}
        assert out["last_restore"]["cross_topology"]
        assert "mesh" in out["last_restore"]["mismatch"]
        assert out["step_after"] == 2 and np.isfinite(out["loss"])


def test_dp_fsdp_relayout_same_device_count(world):
    """Same world, another factoring (dp=1 x fsdp=4 x tp=2): still a
    cross-topology restore, still bit-equal, the kernels on tp."""
    results, _, _, _ = world
    for out in _members(results, "ckpt_restore:relayout"):
        _assert_states_equal(out["state"], _saved(results))
        assert out["sharded"] > 0
        assert list(out["last_restore"]["mismatch"]) == ["mesh"]


def test_same_topology_is_not_cross(world):
    results, _, _, _ = world
    for out in _members(results, "ckpt_restore:same"):
        _assert_states_equal(out["state"], _saved(results))
        assert out["restore_total"] == {"resumed": 1}
        assert out["last_restore"]["cross_topology"] is False


def test_refuses_mismatched_template_shapes(world):
    results, _, _, _ = world
    for out in torch_world.outputs(results, "ckpt_refuse"):
        assert out["raised"] == "ValueError", out
        assert "template expects" in out["message"]


def test_each_rank_writes_its_first_replica_blocks(world):
    """The ranks' shard files together hold one copy of the state
    (dp=4 x fsdp=2: the fsdp pair at dp coordinate 0 writes the sharded
    leaves, rank 0 the replicated ones), and ranks off dp 0 write none."""
    results, _, _, _ = world
    outs = torch_world.outputs(results, "ckpt_save:a")
    for name in RESTORES:
        wrote = [out["wrote"][name] for out in outs]
        assert sum(wrote) == outs[0]["copy_bytes"], (name, wrote)
        assert wrote[0] > wrote[1] > 0 and not any(wrote[2:]), wrote


def test_restore_into_a_whole_template_and_onto_a_tp_mesh(world):
    """``restore_checkpoint`` without a mesh: whole leaves on every rank;
    from a whole template onto dp=2 x fsdp=2 x tp=2 with ``tp_rules``
    left out: the state on that mesh, its kernels on tp (the model's
    layout), bit-equal; rules other than the model's are refused. A step
    on the mesh from there gives the meshless step's loss (a kernel left
    tp-replicated would sum tp copies of every head), and
    ``run_with_checkpointing(mesh=)`` from a whole template resumes
    step 10 cross-topology and takes that step bit for bit."""
    results, _, _, _ = world
    for out in torch_world.outputs(results, "ckpt_whole_and_onto"):
        _assert_states_equal(out["whole"], _saved(results))
        _assert_states_equal(out["onto"], _saved(results))
        assert out["onto_mesh"] and out["apply_fn_mesh"]
        assert out["sharded"] > 0 and out["q_proj"] == ("fsdp", "tp")
        assert out["other_rules"] == "ValueError"
        assert abs(out["loss"] - out["plain_loss"]) <= LOSS_RTOL * abs(
            out["plain_loss"]), (out["loss"], out["plain_loss"])
        report = out["report"]
        assert report["resumed_from_step"] == 10 and report["resharded"]
        assert report["final_step"] == 11
        _assert_states_equal(out["looped"], out["stepped"])


# ------------------------------------------------------------- the loop


def test_run_with_checkpointing_resumes_on_refactored_mesh(world):
    """Segment 1 trains 3 steps on dp=4 x fsdp=2 and saves every 2;
    segment 2 builds its state on the refactored 4-rank mesh and resumes
    at step 2 (``report.resharded``), lost work within the cadence."""
    results, _, _, _ = world
    first = torch_world.outputs(results, "ckpt_loop:a")
    second = _members(results, "ckpt_loop:b")
    assert len(second) == 4
    for out in first:
        assert out["report"]["final_step"] == 3 and out["latest"] == 2
        assert out["report"]["resharded"] is False
        assert out["fingerprint"]["mesh"] == [4, 1, 2, 1, 1, 1]
    for out in second:
        report = out["report"]
        assert report["resumed_from_step"] == 2 and report["resharded"]
        assert report["final_step"] == 4
        assert 3 - report["resumed_from_step"] <= 2
        assert out["fingerprint"]["mesh"] == [2, 1, 2, 1, 1, 1]


def test_run_with_checkpointing_resumes_after_sigterm_bit_equal(world):
    """Process 0 takes a SIGTERM after step 2: every rank stops at the
    agreed boundary, saves, and a fresh state resumes there; the result
    equals an uninterrupted run's bit for bit."""
    results, _, _, _ = world
    for out in torch_world.outputs(results, "ckpt_sigterm"):
        assert out["first"]["preempted"] and out["first"]["final_step"] == 2
        assert out["second"]["resumed_from_step"] == 2
        assert out["second"]["final_step"] == 4
        assert out["second"]["resharded"] is False
        _assert_states_equal(out["resumed"], out["straight"])


# ------------------------------------------------- the two-process restore


def test_multihost_cross_topology_restore_two_processes(world):
    """Ranks 0 and 1 save under a pure-dp layout and restore under an
    fsdp re-layout, each reading only its region; the agreed step is
    process 0's. The same checkpoint then restores whole in this single
    process: the process-count mismatch is cross-topology too."""
    results, _, root, _ = world
    values = np.arange(2 * 4 * 8, dtype=np.float32).reshape(-1, 8)
    outs = _members(results, "ckpt_two_process")
    assert len(outs) == 2
    for rank, out in enumerate(outs):
        assert out["step"] == 5 and out["restored_step"] == 5
        assert out["cross"] and out["restore_total"] == {
            "resumed_cross_topology": 1}
        assert out["region"] == [[0, 8], [4 * rank, 4 * rank + 4]]
        np.testing.assert_array_equal(out["w"], values[:, 4 * rank:][:, :4])
        np.testing.assert_array_equal(out["m"],
                                      values[:, 4 * rank:][:, :4] * 0.5)
    metrics = CheckpointMetrics()
    manager = CheckpointManager(root / "two", metrics=metrics,
                                fingerprint={"mesh": [8, 1, 1, 1, 1, 1]})
    like = {"w": np.zeros_like(values), "m": np.zeros_like(values),
            "step": np.int32(0)}
    restored, step = manager.restore_latest_valid(like)
    assert step == 5 and manager.last_restore["cross_topology"]
    assert "process_count" in manager.last_restore["mismatch"]
    assert metrics.restore_total == {"resumed_cross_topology": 1}
    np.testing.assert_array_equal(restored["w"], values)
    np.testing.assert_array_equal(restored["m"], values * 0.5)


# -------------------------------------------------- across the packages


def test_jax_mesh_checkpoint_restores_onto_a_port_mesh(world):
    """The JAX package's checkpoint of its dp=4 x fsdp=2 state restores
    onto the port's dp=2 x fsdp=2 x tp=2 world bit for bit (bf16 mu
    included), and trains on."""
    results, _, _, jax_state = world
    for out in torch_world.outputs(results, "ckpt_restore:from_jax"):
        _assert_states_equal(out["state"], jax_state)
        assert out["restore_total"] == {"resumed_cross_topology": 1}
        assert out["step_after"] == 2 and np.isfinite(out["loss"])


def test_port_mesh_checkpoint_restores_in_the_jax_package(world):
    """The world's checkpoint of its fsdp=4 x sp=2 state restores in the
    JAX package onto a dp=2 x fsdp=2 x tp=2 mesh (its tp rules) bit for
    bit."""
    results, _, root, _ = world
    want = torch_world.outputs(results, "ckpt_save:to_jax")[0]["state"]
    mesh = jmake_mesh(JMeshSpec(dp=2, fsdp=2, tp=2))
    like = jcreate_lm_state(jbuild_lm(JLMConfig(**CFG), mesh=mesh),
                            jax.random.key(9), (2, BATCH[1]), mesh=mesh)
    restored = jckpt.restore_checkpoint(root / "to_jax", like, mesh=mesh,
                                        tp_rules=JLM_TP_RULES)
    q = restored.params["block_0"]["q_proj"]["kernel"]
    assert "tp" in tuple(q.sharding.spec)
    _assert_states_equal(_jax_state_np(restored), want)


# ------------------------------------------------------ per-block fsdp


@pytest.mark.parametrize("name", sorted(FSDP_CASES))
def test_per_block_fsdp_step_matches_the_reference(world, name):
    """Logits, the loss (every rank the global mean), each leaf's
    gradient and update against the reference's
    step on the same mesh, packed rows differing by rank."""
    results, refs, _, _ = world
    want = refs[name]
    got = _logits(results, name, FSDP_CASES[name][2][0])
    np.testing.assert_allclose(got, want["logits"], atol=LOGITS_ATOL, rtol=0)
    outs = torch_world.outputs(results, f"lm:{name}")
    losses = {out["loss"] for out in outs}
    assert len(losses) == 1, losses
    assert abs(losses.pop() - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    grads = outs[0]["grads"]
    assert sorted(grads) == sorted(want["grads"])
    for path, g in grads.items():
        ref = want["grads"][path]
        err = np.linalg.norm(g - ref) / np.linalg.norm(ref)
        assert err <= GRAD_RTOL, (path, err)
    for out in outs:
        errs = update_errors(out["params"], want["after"], want["before"])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= UPDATE_RTOL, (worst, errs[worst])


@pytest.mark.parametrize("name", sorted(FSDP_CASES))
def test_per_block_fsdp_keeps_at_most_two_blocks_whole(world, name):
    """At every gather of the step, the whole weights alive are at most
    the embedding plus two blocks' fsdp leaves, and the blocks' leaves
    were gathered again in the backward (more gathers than leaves)."""
    results, _, _, _ = world
    spec, cfg, _, _ = FSDP_CASES[name]
    shape = dict(dp=1, pp=1, fsdp=1, tp=1, sp=1, ep=1)
    shape.update(MeshSpec(**spec).resolve(8).__dict__)
    placements = lm_placements(LMConfig(**cfg),
                               types.SimpleNamespace(shape=shape))
    per_block = sum(1 for path, p in placements.items()
                    if path.startswith("block_0/") and "fsdp" in p)
    outer = sum(1 for path, p in placements.items()
                if not path.startswith("block_") and "fsdp" in p)
    assert per_block > 0 and not is_moe_block(LMConfig(**cfg), 0)
    for out in torch_world.outputs(results, f"lm:{name}"):
        assert 0 < out["whole_peak"] <= outer + 2 * per_block, out[
            "whole_peak"]
        assert out["gathers"] > outer + cfg["layers"] * per_block

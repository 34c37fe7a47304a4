"""Pipelined checkpoints and pp on the non-pipelined steps, against the
JAX package on its 8-device virtual CPU mesh.

- ``tests/test_checkpoint.py::TestPipelinedCheckpoint``: a pipelined
  state from a dp2 x pp4 mesh (``create_pp_lm_state``, one step) saved
  by every rank's first-replica blocks and restored through
  ``restore_checkpoint(mesh=)`` into a template from another seed keeps
  its pp placement, equals the saved state bit for bit and steps on.
- Across the packages: the reference's pipelined state, stepped on its
  dp4 x pp2 mesh and saved, restores onto the port's dp2 x pp4 world bit
  for bit (bf16 mu included); the port's checkpoint restores in the JAX
  package onto a dp4 x pp2 mesh, its stacked leaves on pp, bit for bit.
- pp is inert outside the pipelined model, as the reference's is: the
  mesh LM step on dp2 x pp2 x tp2 (every pp rank the same replica and
  rows) matches the reference's step on the same mesh (logits 1e-4
  absolute, loss 1e-5 relative, gradients 1e-4 and f32 AdamW updates
  1e-4 in relative norm), every pp rank alike; resnet18 on
  dp2 x pp2 x fsdp2 equals the port's one-device step and the
  reference's (``tests/test_torch_mesh_train.py``'s ResNet limits).

One gloo world of 8 ranks runs the port (``tests/torch_world.py``
``case_pp_ckpt``, ``case_lm``, ``case_resnet``); the JAX checkpoint is
written before it starts. A hang fails the world's wait.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_world
from kubeflow_tpu.models import checkpoint as jckpt
from kubeflow_tpu.models.pipeline_lm import PipelinedLM as JPipelinedLM
from kubeflow_tpu.models.pipeline_lm import (
    create_pp_lm_state as jcreate_pp_lm_state,
)
from kubeflow_tpu.models.pipeline_lm import (
    make_pp_lm_train_step as jmake_pp_lm_train_step,
)
from kubeflow_tpu.models.transformer import LMConfig as JLMConfig
from kubeflow_tpu.parallel import MeshSpec as JMeshSpec
from kubeflow_tpu.parallel import make_mesh as jmake_mesh
from test_torch_mesh_ckpt import _assert_states_equal, _jax_state_np
from test_torch_mesh_train import (
    F32_ADAMW,
    GRAD_RTOL,
    LOGITS_ATOL,
    LOSS_RTOL,
    UPDATE_RTOL,
    _check_resnet,
    _flat,
    _image_batch,
    _jax_lm_init,
    _jax_lm_refs,
    _jax_resnet,
    _logits,
    _resnet_np,
    _resnet_variables,
    update_errors,
)

CFG = dict(vocab=64, layers=4, dim=32, heads=2)
MODEL = dict(num_microbatches=2)
SPEC = dict(dp=2, pp=4)
JAX_SPEC = dict(dp=4, pp=2)
INERT_SPEC = dict(dp=2, pp=2, tp=2)
INERT_CFG = dict(vocab=128, layers=2, dim=64, heads=4)
RESNET_SPEC = dict(dp=2, pp=2, fsdp=2)


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _jax_model(spec):
    return JPipelinedLM(JLMConfig(**CFG), jmake_mesh(JMeshSpec(**spec)),
                        **MODEL)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp_ckpt")
    jmodel = _jax_model(JAX_SPEC)
    jstate, _ = jmake_pp_lm_train_step(jmodel)(
        jcreate_pp_lm_state(jmodel, jax.random.key(3)),
        {"tokens": jnp.asarray(_tokens((4, 16), CFG["vocab"], 3))})
    jckpt.CheckpointManager(root / "from_jax").save(10, jstate)
    jax_saved = _jax_state_np(jstate)
    tokens = _tokens((4, 32), INERT_CFG["vocab"], 5)
    jax_lm, params, shards = _jax_lm_init(INERT_SPEC, INERT_CFG, 32,
                                          adamw=F32_ADAMW)
    jres = _resnet_variables(6)
    images, labels = _image_batch(6)
    tasks = [
        ("pp_ckpt", dict(root=str(root), spec=SPEC, cfg=CFG, model=MODEL,
                         tokens=_tokens((4, 16), CFG["vocab"]),
                         jax_dir=str(root / "from_jax"))),
        ("lm:inert", dict(spec=INERT_SPEC, cfg=INERT_CFG, params=params,
                          tokens=tokens, forward_tokens=tokens,
                          adamw=F32_ADAMW)),
        ("resnet:pp", dict(spec=RESNET_SPEC, variables=_resnet_np(jres),
                           images=images, labels=labels, meshless=True)),
    ]
    world = torch_world.World(8, tasks, root / "world")
    refs = {"jax_saved": jax_saved,
            "inert": _jax_lm_refs(*jax_lm, tokens, None, True),
            "inert_before": params,
            "resnet": _jax_resnet(jres, images, labels)}
    return world.wait(), refs, root


def test_pp_state_roundtrip_preserves_stage_sharding(world):
    """TestPipelinedCheckpoint: saved from dp2 x pp4, restored into a
    template from another seed: step 1, blocks on pp (each rank its
    (1, 32, 32) q_proj slice), bit-equal, the model kept, a step on."""
    results, _, _ = world
    for out in torch_world.outputs(results, "pp_ckpt"):
        assert out["step"] == 1
        assert out["q_proj"][0] == "pp" and out["q_shape"] == (1, 32, 32)
        assert out["same_model"]
        _assert_states_equal(out["restored"], out["saved"])
        assert np.isfinite(out["loss_on"])


def test_jax_pp_checkpoint_restores_onto_the_port_mesh(world):
    """The reference's state after one step (its ``step`` leaf 1),
    committed as step 10 from dp4 x pp2, on the port's dp2 x pp4."""
    results, refs, _ = world
    for out in torch_world.outputs(results, "pp_ckpt"):
        assert out["from_jax_step"] == 1
        _assert_states_equal(out["from_jax"], refs["jax_saved"])


def test_port_pp_checkpoint_restores_in_the_jax_package(world):
    """The port's dp2 x pp4 checkpoint onto the reference's dp4 x pp2
    template (its shardings reused): blocks on pp, bit for bit."""
    results, _, root = world
    want = torch_world.outputs(results, "pp_ckpt")[0]["saved"]
    jmodel = _jax_model(JAX_SPEC)
    like = jcreate_pp_lm_state(jmodel, jax.random.key(9))
    restored = jckpt.restore_checkpoint(root / "port", like,
                                        mesh=jmodel.mesh)
    spec = restored.params["blocks"]["q_proj"]["kernel"].sharding.spec
    assert spec[0] == "pp"
    _assert_states_equal(_jax_state_np(restored), want)


def test_pp_is_inert_on_the_mesh_lm_step(world):
    """The non-pipelined LM on dp2 x pp2 x tp2 against the reference's
    step on its mesh (pp inert in both): logits, loss, gradients and
    updates; the two pp ranks of each replica alike."""
    results, refs, _ = world
    want = refs["inert"]
    got = _logits(results, "inert", 4)
    np.testing.assert_allclose(got, want["logits"], atol=LOGITS_ATOL, rtol=0)
    outs = torch_world.outputs(results, "lm:inert")
    for out in outs:
        assert abs(out["loss"] - want["loss"]) <= LOSS_RTOL * abs(
            want["loss"])
    for path, g in outs[0]["grads"].items():
        err = np.linalg.norm(g - want["grads"][path]) / np.linalg.norm(
            want["grads"][path])
        assert err <= GRAD_RTOL, (path, err)
    errs = update_errors(outs[0]["params"], want["after"],
                         _flat(refs["inert_before"]))
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst[1] <= UPDATE_RTOL, worst
    replicas: dict = {}
    for out in outs:
        key = tuple(v for k, v in out["coords"].items() if k != "pp")
        twin = replicas.setdefault(key, out)
        for path, shard in out["shards"].items():
            np.testing.assert_array_equal(shard, twin["shards"][path])
        np.testing.assert_array_equal(out["logits"], twin["logits"])


def test_resnet_on_a_pp_mesh_equals_the_one_device_step(world):
    """resnet18 on dp2 x pp2 x fsdp2: pp inert, the whole batch's
    BatchNorm moments; the same step as the port's and the reference's
    one-device steps."""
    results, refs, _ = world
    for out in torch_world.outputs(results, "resnet:pp"):
        _check_resnet(out["mesh"], refs["resnet"])
        _check_resnet(out["mesh"], out["meshless"])

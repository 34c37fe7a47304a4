"""The port's parallel layer against the JAX package, in one process with
no world: ``kubeflow_tpu_torch/parallel/{distributed,mesh}.py`` beside
``kubeflow_tpu/parallel/{distributed,mesh}.py``.

Every case of ``tests/test_parallel.py`` that needs no process group
(MeshSpec's resolve and refactor with each refusal, DistributedEnv,
slice_env_for_rank, the row-major and multislice layouts), and
``param_sharding`` held leaf by leaf against the reference's
``NamedSharding.spec`` on the 8-device virtual CPU mesh, for each of its
branches (small leaf, fsdp's largest dim, the LM's tp column and row
rules with fsdp on the other dim, ``ep`` expert stacks, ``stage_axis``)
over the LM's, the MoE LM's and resnet18's parameter and state trees.
The multi-rank paths run in gloo worlds: ``tests/test_torch_ring.py``
and ``tests/test_torch_mesh_train.py``.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu import parallel as jpar
from kubeflow_tpu.models import create_train_state as jcreate_train_state
from kubeflow_tpu.models import resnet18 as jresnet18
from kubeflow_tpu.models.train import state_shardings as jstate_shardings
from kubeflow_tpu.models.transformer import LM_TP_RULES as JLM_TP_RULES
from kubeflow_tpu.models.transformer import LMConfig as JLMConfig
from kubeflow_tpu.models.transformer import build_lm as jbuild_lm
from kubeflow_tpu.models.transformer import create_lm_state as jcreate_lm_state
from kubeflow_tpu.parallel import distributed as jdist
from kubeflow_tpu_torch import parallel as tpar
from kubeflow_tpu_torch.models import (
    LM_TP_RULES,
    LMConfig,
    build_lm,
    create_lm_state,
    create_train_state,
    resnet18,
    state_shardings,
)
from kubeflow_tpu_torch.models.optim import flatten
from kubeflow_tpu_torch.parallel import distributed as tdist
from kubeflow_tpu_torch.parallel.mesh import layout, multislice_layout


def _outcome(fn):
    """(result, None) or (None, the exception's type name)."""
    try:
        return fn(), None
    except ValueError as exc:
        return None, type(exc).__name__


def test_axes_and_tp_rules_match_the_reference():
    assert tpar.AXES == jpar.mesh.AXES
    assert LM_TP_RULES == JLM_TP_RULES


# ------------------------------------------------------------- MeshSpec


@pytest.mark.parametrize("spec,n", [
    (dict(dp=-1, fsdp=2, tp=2), 8), (dict(dp=3, fsdp=3), 8),
    (dict(), 8), (dict(dp=-1, sp=3), 8), (dict(dp=2, pp=2, ep=2), 8),
    (dict(dp=-1, tp=4, sp=2), 8), (dict(dp=1), 1), (dict(dp=-1), 16)])
def test_mesh_spec_resolve_matches_reference(spec, n):
    got = _outcome(lambda: tpar.MeshSpec(**spec).resolve(n))
    want = _outcome(lambda: jpar.MeshSpec(**spec).resolve(n))
    assert (got[0] and got[0].shape, got[1]) == (want[0] and want[0].shape,
                                                 want[1])


@pytest.mark.parametrize("spec,n_from,n_to", [
    (dict(dp=2, fsdp=4, tp=2), 16, 8), (dict(dp=2, fsdp=4, tp=2), 16, 4),
    (dict(dp=2, fsdp=4, tp=2), 16, 2), (dict(dp=2, fsdp=4, tp=2), 16, 1),
    (dict(dp=1, fsdp=2, tp=2), 4, 16), (dict(dp=2, fsdp=2, tp=2), 8, 8),
    (dict(dp=4, pp=2), 8, 4), (dict(dp=2, fsdp=2), 4, 3),
    (dict(dp=2, fsdp=2), 4, 6), (dict(dp=2, fsdp=2), 4, 0),
    (dict(dp=1, pp=2), 2, 1), (dict(dp=1, sp=4, tp=2), 8, 2)])
def test_mesh_spec_refactor_matches_reference(spec, n_from, n_to):
    got = _outcome(
        lambda: tpar.MeshSpec(**spec).resolve(n_from).refactor(n_to))
    want = _outcome(
        lambda: jpar.MeshSpec(**spec).resolve(n_from).refactor(n_to))
    assert (got[0] and got[0].shape, got[1]) == (want[0] and want[0].shape,
                                                 want[1])
    if got[0] is not None:
        assert got[0].n_devices == n_to


def test_refactor_refuses_an_unresolved_spec_and_keeps_identity():
    with pytest.raises(ValueError, match="resolve"):
        tpar.MeshSpec(dp=-1).refactor(4)
    spec = tpar.MeshSpec(dp=2, fsdp=2, tp=2).resolve(8)
    assert spec.refactor(8) is spec


# ------------------------------------------------------ distributed env


@pytest.mark.parametrize("env", [
    {},
    jdist.slice_env_for_rank("nb", "user-ns", rank=2, num_replicas=4),
    jdist.slice_env_for_rank("nb", "ns", rank=0, num_replicas=1),
    {"TPU_WORKER_ID": "1", "KFT_NUM_PROCESSES": "2",
     "JAX_COORDINATOR_ADDRESS": "nb-0.nb-hosts.ns.svc:8476"},
    {"TPU_WORKER_ID": "1", "KFT_NUM_PROCESSES": "2",
     "KFT_COORDINATOR_ADDRESS": "a:1", "JAX_COORDINATOR_ADDRESS": "b:2"},
    {"TPU_WORKER_ID": "3", "TPU_WORKER_HOSTNAMES": "h0,h1,h2,h3"}])
def test_distributed_env_matches_reference(env):
    got = tdist.DistributedEnv.from_env(env)
    want = jdist.DistributedEnv.from_env(env)
    assert (got.process_id, got.num_processes, got.coordinator_address,
            got.worker_hostnames, got.is_multihost) == (
        want.process_id, want.num_processes, want.coordinator_address,
        want.worker_hostnames, want.is_multihost)


@pytest.mark.parametrize("args", [
    ("nb", "user-ns", 2, 4, None), ("nb", "ns", 0, 1, None),
    ("train", "team-a", 7, 8, "custom-svc"), ("x", "y", 1, 2, None)])
def test_slice_env_for_rank_matches_reference(args):
    assert tdist.slice_env_for_rank(*args) == jdist.slice_env_for_rank(
        *args)


def test_multihost_parse_names_the_headless_service():
    env = tpar.slice_env_for_rank("nb", "user-ns", rank=2, num_replicas=4)
    denv = tpar.DistributedEnv.from_env(env)
    assert (denv.process_id, denv.num_processes) == (2, 4)
    assert denv.coordinator_address == "nb-0.nb-hosts.user-ns.svc:8476"
    assert denv.worker_hostnames[3] == "nb-3.nb-hosts.user-ns.svc"
    single = tpar.slice_env_for_rank("nb", "ns", rank=0, num_replicas=1)
    assert "KFT_COORDINATOR_ADDRESS" not in single


@pytest.mark.parametrize("env,want", [
    ({"TPU_WORKER_ID": "2", "KFT_NUM_PROCESSES": "4"}, (2, 4, 0)),
    ({"TPU_WORKER_ID": "2", "KFT_NUM_PROCESSES": "4",
      "LOCAL_WORLD_SIZE": "8", "LOCAL_RANK": "3"}, (19, 32, 3)),
    ({"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "1"}, (1, 4, 1)),
    ({}, (0, 1, 0))])
def test_process_rank_maps_pods_and_local_processes(env, want):
    """One process per GPU: global rank = pod rank x LOCAL_WORLD_SIZE +
    LOCAL_RANK, else one process per pod."""
    denv = tdist.DistributedEnv.from_env(env)
    assert tdist.process_rank(denv, env) == want
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        tdist.process_rank(denv, {**env, "LOCAL_WORLD_SIZE": "2",
                                  "LOCAL_RANK": "2"})


def test_initialize_from_env_is_a_noop_for_one_process():
    denv = tpar.initialize_from_env({}, device="cpu")
    assert not denv.is_multihost
    assert not torch.distributed.is_initialized()


def test_initialize_from_env_needs_a_coordinator_for_several_processes():
    with pytest.raises(ValueError, match="coordinator"):
        tpar.initialize_from_env({"KFT_NUM_PROCESSES": "2"}, device="cpu")
    assert not torch.distributed.is_initialized()


def test_make_mesh_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpar.make_mesh(tpar.MeshSpec())
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------- layout


@pytest.mark.parametrize("spec", [
    dict(dp=2, fsdp=2, tp=2), dict(dp=-1, sp=4), dict(tp=8),
    dict(dp=2, pp=2, ep=2), dict(dp=4, fsdp=2)])
def test_ranks_lay_out_row_major_like_jax_devices(spec):
    """Rank r holds the block JAX device r holds."""
    jmesh = jpar.make_mesh(jpar.MeshSpec(**spec))
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    np.testing.assert_array_equal(layout(tpar.MeshSpec(**spec), 8), ids)


def test_multislice_layout_is_dp_slice_major():
    ranks = multislice_layout(tpar.MeshSpec(dp=4, fsdp=2), 2, 8)
    jmesh = jpar.make_multislice_mesh(jpar.MeshSpec(dp=4, fsdp=2),
                                      num_slices=2)
    np.testing.assert_array_equal(
        ranks, np.vectorize(lambda d: d.id)(jmesh.devices))
    assert set(ranks[:2].flatten()) == {0, 1, 2, 3}
    assert set(ranks[2:].flatten()) == {4, 5, 6, 7}
    np.testing.assert_array_equal(
        multislice_layout(tpar.MeshSpec(dp=8), 1, 8).flatten(), range(8))


@pytest.mark.parametrize("spec,slices,match", [
    (dict(dp=1, fsdp=8), 2, "data parallelism"),
    (dict(dp=-1), 3, "not divisible")])
def test_multislice_layout_refuses_what_the_reference_refuses(spec, slices,
                                                              match):
    with pytest.raises(ValueError, match=match):
        multislice_layout(tpar.MeshSpec(**spec), slices, 8)
    with pytest.raises(ValueError, match=match):
        jpar.make_multislice_mesh(jpar.MeshSpec(**spec), num_slices=slices)


def test_canonical_placements_match_the_reference_specs():
    jmesh = jpar.make_mesh(jpar.MeshSpec(dp=4, fsdp=2))
    assert tpar.batch_sharding() == tuple(jpar.batch_sharding(jmesh).spec)
    assert tpar.token_sharding() == tuple(jpar.token_sharding(jmesh).spec)
    assert tpar.replicated() == tuple(jpar.replicated(jmesh).spec)


# ------------------------------------------------------- param_sharding


def _shape_of(jmesh):
    return types.SimpleNamespace(shape=dict(jmesh.shape))


def _spec(placement, ndim) -> tuple:
    placement = tuple(placement)
    return placement + (None,) * (ndim - len(placement))


def _lm_tree(cfg_kw, state: bool):
    cfg = JLMConfig(**cfg_kw)
    model = jbuild_lm(cfg)
    if state:
        return jax.eval_shape(lambda: jcreate_lm_state(
            model, jax.random.key(0), (2, 16)))
    return jax.eval_shape(model.init, jax.random.key(0),
                          jnp.zeros((2, 16), jnp.int32))["params"]


def _resnet_tree(state: bool):
    model = jresnet18(num_classes=8, width=8)
    if state:
        return jax.eval_shape(lambda: jcreate_train_state(
            model, jax.random.key(0), (2, 32, 32, 3)))
    return jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((2, 32, 32, 3)), train=False))


def _stacked_tree(cfg_kw):
    """A pipeline's depth-stacked block leaves: (layers, ...) shapes."""
    params = _lm_tree(cfg_kw, state=False)
    layers = cfg_kw["layers"]
    return {"blocks": jax.tree.map(
        lambda leaf: jax.ShapeDtypeStruct((layers,) + leaf.shape,
                                          leaf.dtype), params["block_0"])}


MHA = dict(vocab=128, layers=2, dim=64, heads=4)
GQA = dict(vocab=128, layers=2, dim=64, heads=4, kv_heads=2)
BIG = dict(vocab=512, layers=2, dim=128, heads=8, kv_heads=4)
MOE = dict(vocab=128, layers=2, dim=64, heads=4, moe_experts=4)
STACK = dict(vocab=128, layers=4, dim=128, heads=4)

SHARDING_CASES = [
    # (tree, mesh spec, tp rules, stage axis)
    ("lm_mha", dict(dp=4, fsdp=2), "lm", None),
    ("lm_mha", dict(dp=2, fsdp=2, tp=2), "lm", None),
    ("lm_mha", dict(tp=8), "lm", None),
    ("lm_gqa", dict(dp=2, fsdp=2, tp=2), "lm", None),
    ("lm_big", dict(fsdp=8), "lm", None),
    ("lm_big", dict(dp=2, fsdp=2, tp=2), "lm", None),
    ("lm_big", dict(dp=2, fsdp=2, tp=2), None, None),
    ("lm_big_state", dict(dp=1, fsdp=4, tp=2), "lm", None),
    ("lm_moe", dict(dp=4, ep=2), "lm", None),
    ("lm_moe", dict(dp=2, fsdp=2, ep=2), "lm", None),
    ("stacked", dict(dp=2, pp=2, tp=2), "lm", "pp"),
    ("stacked", dict(pp=2, fsdp=2, tp=2), "lm", "pp"),
    ("stacked", dict(dp=1, pp=4, fsdp=2), None, "pp"),
    ("resnet", dict(dp=4, fsdp=2), None, None),
    ("resnet", dict(dp=2, fsdp=2, tp=2), None, None),
    ("resnet_state", dict(fsdp=8), None, None),
]


def _tree(name):
    return {"lm_mha": lambda: _lm_tree(MHA, False),
            "lm_gqa": lambda: _lm_tree(GQA, False),
            "lm_big": lambda: _lm_tree(BIG, False),
            "lm_big_state": lambda: _lm_tree(BIG, True),
            "lm_moe": lambda: _lm_tree(MOE, False),
            "stacked": lambda: _stacked_tree(STACK),
            "resnet": lambda: _resnet_tree(False),
            "resnet_state": lambda: _resnet_tree(True)}[name]()


@pytest.mark.parametrize("tree,spec,rules,stage", SHARDING_CASES)
def test_param_sharding_matches_the_reference_leaf_by_leaf(tree, spec, rules,
                                                           stage):
    jmesh = jpar.make_mesh(jpar.MeshSpec(**spec))
    rules = JLM_TP_RULES if rules == "lm" else None
    flat, _ = jax.tree_util.tree_flatten_with_path(_tree(tree))
    branches = set()
    for path, leaf in flat:
        want = jpar.param_sharding(jmesh, path, leaf, tp_rules=rules,
                                   stage_axis=stage).spec
        got = tpar.param_sharding(_shape_of(jmesh), path, leaf,
                                  tp_rules=rules, stage_axis=stage)
        ndim = len(leaf.shape)
        assert _spec(got, ndim) == _spec(want, ndim), \
            jax.tree_util.keystr(path)
        branches.update(a for a in _spec(got, ndim) if a)
    # Each case reaches the branch it is there for.
    expected = {a for a in ("fsdp", "tp", "ep", "pp")
                if spec.get(a, 1) > 1 and (a != "tp" or rules)}
    assert branches == expected


def test_param_sharding_replicates_small_leaves_and_shards_large_ones():
    shape = types.SimpleNamespace(shape=dict(zip(tpar.AXES,
                                                 (4, 1, 2, 1, 1, 1))))
    assert tpar.param_sharding(shape, (), torch.empty(64)) == ()
    assert tpar.param_sharding(shape, (), torch.empty(512, 512)) == (
        "fsdp", None)
    # Largest dim first, the first that divides.
    assert tpar.param_sharding(shape, (), torch.empty(3, 32768, 5)) == (
        None, "fsdp", None)
    assert tpar.param_sharding(shape, ("head", "kernel"),
                               torch.empty(129, 255)) == ()


def test_gqa_kv_heads_must_divide_tp_for_the_megatron_layout():
    """``check_tp_layout`` refuses as the reference does: kv_heads=2 at
    tp=4 raises, kv_heads=4 builds (the model reads only the mesh's
    shape and its tp group here)."""
    mesh = types.SimpleNamespace(
        shape=dict(zip(tpar.AXES, (2, 1, 1, 4, 1, 1))),
        group=lambda axes: None)
    jmesh = jpar.make_mesh(jpar.MeshSpec(dp=2, tp=4))
    for kv, raises in ((2, True), (4, False)):
        cfg = dict(vocab=64, layers=1, dim=512, heads=8, kv_heads=kv)
        if raises:
            with pytest.raises(ValueError, match="Megatron"):
                build_lm(LMConfig(**cfg), mesh=mesh)
            with pytest.raises(ValueError, match="Megatron"):
                jbuild_lm(JLMConfig(**cfg), mesh=jmesh)
        else:
            assert build_lm(LMConfig(**cfg), mesh=mesh).mesh is mesh
            jbuild_lm(JLMConfig(**cfg), mesh=jmesh)


@pytest.mark.parametrize("cfg_kw,spec", [
    (BIG, dict(dp=1, fsdp=4, tp=2)), (MHA, dict(dp=2, fsdp=2, tp=2)),
    (GQA, dict(tp=2, sp=4))])
def test_lm_state_shardings_match_the_reference(cfg_kw, spec):
    jmesh = jpar.make_mesh(jpar.MeshSpec(**spec))
    jshard = jstate_shardings(_lm_tree(cfg_kw, True), jmesh,
                              tp_rules=JLM_TP_RULES)
    state = create_lm_state(build_lm(LMConfig(**cfg_kw)), seed=0,
                            device="cpu")
    got = state_shardings(state, _shape_of(jmesh), tp_rules=LM_TP_RULES)
    want = {"/".join(jpar.mesh.path_key(p) for p in path): sh.spec
            for path, sh in jax.tree_util.tree_flatten_with_path(
                jshard.params)[0]}
    assert sorted(got["params"]) == sorted(want)
    for path, placement in got["params"].items():
        ndim = len(dict(flatten(state.params))[path].shape)
        assert _spec(placement, ndim) == _spec(want[path], ndim), path
    assert got["batch_stats"] == {}


def test_resnet_state_shardings_match_the_reference():
    jmesh = jpar.make_mesh(jpar.MeshSpec(dp=2, fsdp=4))
    jshard = jstate_shardings(_resnet_tree(True), jmesh)
    state = create_train_state(resnet18(num_classes=8, width=8), 0,
                               (2, 32, 32, 3), device="cpu")
    got = state_shardings(state, _shape_of(jmesh))
    for group in ("params", "batch_stats"):
        want = {"/".join(jpar.mesh.path_key(p) for p in path): sh.spec
                for path, sh in jax.tree_util.tree_flatten_with_path(
                    getattr(jshard, group))[0]}
        assert sorted(got[group]) == sorted(want)
        leaves = dict(flatten(getattr(state, group)))
        for path, placement in got[group].items():
            ndim = leaves[path].ndim
            assert _spec(placement, ndim) == _spec(want[path], ndim), path
    assert any("fsdp" in p for p in got["params"].values())

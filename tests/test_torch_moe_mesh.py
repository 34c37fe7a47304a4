"""The MoE LM on meshes, experts on ``ep``: the port
(``kubeflow_tpu_torch/models/transformer.py``'s ``ExpertParallel``)
against the JAX package's GSPMD on its 8-device virtual CPU mesh.

One gloo world of 8 ranks (``tests/torch_world.py``) runs every case from
the reference's own init on the same mesh, carried across as numpy and
laid onto the port's mesh with ``shard_state``. Cases, from
``tests/test_ops.py``: ``test_top2_lm_trains_on_ep_mesh`` (top-2 on
dp=2 x ep=4), ``test_moe_matches_itself_across_layouts`` (ep=8, 8
experts), ``test_experts_shard_over_ep`` (each rank's expert shard is the
reference device's), and the products with tp, sp (packed rows, routing
over the whole sequence) and fsdp (the stacks on ep and fsdp, gathered
per block), for top-k and expert-choice routing.

Held against the reference (f32): logits 1e-4 absolute, the loss 1e-5
relative, every leaf's gradient 1e-4 in relative norm on every rank
(``tests/test_torch_mesh_train.py``'s limits), and each leaf's update
1e-4 in relative norm under an f32 AdamW (``F32_ADAMW``: lr 0.1, eps
1e-3, f32 moments, so a first step is smooth in the gradient); each MoE
block's aux 1e-5 relative and its expert load exactly (the whole batch's,
on every rank).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_world
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

MOE = dict(vocab=128, layers=2, dim=64, heads=2, moe_experts=4)
TOP2 = dict(MOE, moe_top_k=2)
EC = dict(MOE, moe_router="expert_choice")

# name: (mesh spec, config, batch shape, packing seed or None)
CASES = {
    "top2_dp2_ep4": (dict(dp=2, ep=4), TOP2, (4, 64), None),
    "top1_ep8": (dict(dp=1, ep=8), dict(MOE, moe_experts=8), (2, 32), None),
    "top2_dp2_tp2_ep2": (dict(dp=2, tp=2, ep=2), TOP2, (4, 64), None),
    "top2_dp2_sp2_ep2": (dict(dp=2, sp=2, ep=2), TOP2, (4, 64), 21),
    "top2_dp2_fsdp2_ep2": (dict(dp=2, fsdp=2, ep=2), TOP2, (4, 64), None),
    "ec_dp2_ep4": (dict(dp=2, ep=4), EC, (4, 64), None),
    "ec_dp2_sp2_ep2": (dict(dp=2, sp=2, ep=2), EC, (4, 64), 22),
    "ec_fsdp2_tp2_ep2": (dict(dp=1, fsdp=2, tp=2, ep=2), EC, (2, 64), None),
}


def _jax_sown(model, state, tokens, seg) -> dict:
    """What the reference's MoE blocks sow on its mesh (global values)."""
    apply = jax.jit(lambda p, t, s: model.apply(
        {"params": p}, t, s, mutable=["intermediates"]))
    _, mods = apply(state.params, jnp.asarray(tokens),
                    None if seg is None else jnp.asarray(seg))
    return {blk: {key: np.asarray(vals["moe"][key][0])
                  for key in ("moe_aux", "moe_expert_load")
                  if key in vals["moe"]}
            for blk, vals in mods["intermediates"].items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tasks, pending, refs = [], {}, {}
    for name, (spec, cfg, shape, seg_seed) in CASES.items():
        rng = np.random.default_rng(len(name))
        tokens = rng.integers(0, cfg["vocab"], size=shape)
        seg = None if seg_seed is None else packed(*shape, seed=seg_seed)
        jax_state, params, shards = _jax_lm_init(spec, cfg, shape[1],
                                                 adamw=F32_ADAMW)
        pending[name] = (jax_state, tokens, seg)
        refs[name] = {"shards": shards, "before": _flat(params)}
        tasks.append((f"lm:{name}", dict(
            spec=spec, cfg=cfg, params=params, tokens=tokens,
            segment_ids=seg, forward_tokens=tokens, forward_segment_ids=seg,
            adamw=F32_ADAMW)))
    run = torch_world.World(8, tasks, tmp_path_factory.mktemp("moe_world"))
    for name, (jax_state, tokens, seg) in pending.items():
        _, _, model, state = jax_state
        refs[name]["sown"] = _jax_sown(model, state, tokens, seg)
        refs[name].update(_jax_lm_refs(*jax_state, tokens, seg, True))
    return run.wait(timeout=900), refs


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_mesh_forward_matches_the_reference(world, name):
    results, refs = world
    got = _logits(results, name, CASES[name][2][0])
    np.testing.assert_allclose(got, refs[name]["logits"], atol=LOGITS_ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_mesh_aux_and_expert_load_match_the_reference(world, name):
    """Each MoE block's aux (top-k; its two means over the whole batch)
    and per-expert load on every rank."""
    results, refs = world
    want = refs[name]["sown"]
    for out in torch_world.outputs(results, f"lm:{name}"):
        assert sorted(out["sown"]) == sorted(want)
        for blk, vals in want.items():
            assert sorted(out["sown"][blk]) == sorted(vals)
            np.testing.assert_array_equal(out["sown"][blk]["moe_expert_load"],
                                          vals["moe_expert_load"])
            if "moe_aux" in vals:
                np.testing.assert_allclose(out["sown"][blk]["moe_aux"],
                                           vals["moe_aux"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_mesh_step_matches_the_reference(world, name):
    """The loss (the aux counted once), every leaf's gradient on every
    rank (experts', the router's, and the leaves ep, tp and sp
    replicate) and each leaf's update."""
    results, refs = world
    want = refs[name]
    outs = torch_world.outputs(results, f"lm:{name}")
    losses = {out["loss"] for out in outs}
    assert len(losses) == 1, losses
    assert abs(losses.pop() - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    for out in outs:
        assert sorted(out["grads"]) == sorted(want["grads"])
        for path, g in out["grads"].items():
            ref = want["grads"][path]
            err = np.linalg.norm(g - ref) / np.linalg.norm(ref)
            assert err <= GRAD_RTOL, (path, err)
        errs = update_errors(out["params"], want["after"], want["before"])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= UPDATE_RTOL, (worst, errs[worst])


@pytest.mark.parametrize("name", ["top2_dp2_ep4", "top2_dp2_fsdp2_ep2"])
def test_experts_shard_over_ep(world, name):
    """Each rank's expert stacks are the reference device's shard: E / ep
    experts on dim 0 (and fsdp on the largest other dim)."""
    results, refs = world
    spec = CASES[name][0]
    shards = refs[name]["shards"]
    for out in torch_world.outputs(results, f"lm:{name}"):
        for path in ("block_1/moe/experts_up", "block_1/moe/experts_down"):
            local, ref = out["shards"][path], shards[path][out["rank"]]
            assert local.shape[0] == MOE["moe_experts"] // spec["ep"]
            np.testing.assert_array_equal(local, ref, err_msg=path)

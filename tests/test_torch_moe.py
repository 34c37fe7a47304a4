"""CPU parity of the port's MoE layer, its training, its decode and the
serialized serving fallback against the JAX package.

Inputs come from seeded numpy generators; weights are the reference's,
carried across by ``params_from_jax``/``train_state_from_jax``. The
router probabilities of a random model are untied, so ``torch.argmax``
and ``torch.topk`` choose the experts the reference chooses (the port's
docstrings say why ties could differ). Tolerances, each with its reason:

- ``TOL32`` (atol = rtol = 2e-5): f32 on both sides, the same arithmetic
  summed in another order (the layer's outputs and logits of order one);
  the routing diagnostics (expert loads, the slot maximum) are counts and
  must be equal.
- Step-0 gradients: each leaf within 1e-4 of the reference's in relative
  norm (measured ~1e-6; the router's gradient passes through the
  renormalised gates and the aux term, a few more roundings).
- Carried-state training (the checkpoint cases): losses within 1e-5
  absolute, as ``tests/test_torch_train.py`` holds a carried dense state.
- Decode and the fallback engine: greedy tokens equal (f32); sampled
  streams equal the port's own ``generate`` with the same seed, bit for
  bit (the port samples from a ``torch.Generator``, ROADMAP §C).

The JAX side runs jitted and keeps to 2 layers and dim 32: its MoE
compile is the slow part.
"""

from __future__ import annotations

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import LMConfig as JConfig
from kubeflow_tpu.models import build_lm as jbuild_lm
from kubeflow_tpu.models import checkpoint as jckpt
from kubeflow_tpu.models import create_lm_state as jcreate_lm_state
from kubeflow_tpu.models import generate as jgenerate
from kubeflow_tpu.models import make_lm_train_step as jmake_step
from kubeflow_tpu.models.decoding import KVCache as JKVCache
from kubeflow_tpu.models.decoding import forward_with_cache as jforward
from kubeflow_tpu.models.transformer import MoEFFN
from kubeflow_tpu.models.transformer import _moe_aux_total
from kubeflow_tpu.models.transformer import lm_loss as jlm_loss
from kubeflow_tpu_torch.models import (
    AdamW,
    LMConfig,
    build_lm,
    create_lm_state,
    make_lm_train_step,
    train_state_from_jax,
)
from kubeflow_tpu_torch.models.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.decoding import (
    Int8Linear,
    KVCache,
    forward_with_cache,
    generate,
    quantize_decode_params,
    stack_decode_params,
)
from kubeflow_tpu_torch.models.optim import flatten
from kubeflow_tpu_torch.models.speculative import speculative_generate
from kubeflow_tpu_torch.models.transformer import (
    init_params,
    moe_ffn,
    param_count,
)
from kubeflow_tpu_torch.serving import (
    GenerateFallbackEngine,
    InferenceGateway,
    make_engine,
)

TOL32 = dict(atol=2e-5, rtol=2e-5)
SMALL = dict(vocab=64, layers=2, dim=32, heads=4, kv_heads=2, moe_experts=4)


def _cfgs(**kw):
    fields = {**SMALL, **kw}
    return (JConfig(dtype=jnp.float32, **fields),
            LMConfig(dtype=torch.float32, **fields))


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------ the layer

# (name, top k, capacity factor, router): 0.5 drops tokens past capacity.
LAYER_CASES = [
    ("top1", 1, 1.25, "topk"),
    ("top1_drops", 1, 0.5, "topk"),
    ("top2", 2, 1.25, "topk"),
    ("top2_drops", 2, 0.5, "topk"),
    ("expert_choice", 1, 1.25, "expert_choice"),
]


@pytest.mark.parametrize("case", LAYER_CASES, ids=lambda c: c[0])
def test_moe_ffn_matches_moeffn_apply(case):
    _, k, factor, router = case
    jcfg, tcfg = _cfgs(moe_top_k=k, moe_capacity_factor=factor,
                       moe_router=router)
    x = np.random.default_rng(0).standard_normal((2, 16, 32)).astype(
        np.float32)
    layer = MoEFFN(jcfg)
    variables = layer.init(jax.random.key(1), jnp.asarray(x))
    want, mods = layer.apply(variables, jnp.asarray(x),
                             mutable=["intermediates"])
    p = jax.tree.map(np.array, variables["params"])
    tp = {"router": {"kernel": torch.from_numpy(p["router"]["kernel"])},
          "experts_up": torch.from_numpy(p["experts_up"]),
          "experts_down": torch.from_numpy(p["experts_down"])}
    sow = {}
    got = moe_ffn(tcfg, tp, torch.from_numpy(x), sow)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL32)
    inter = {key: np.asarray(val[0]) for key, val in
             mods["intermediates"].items()}
    assert sorted(sow) == sorted(inter)
    assert ("moe_aux" in sow) == (router == "topk")
    for key in ("moe_expert_load", "moe_slot_max"):
        assert np.array_equal(_np(sow[key]), inter[key]), key
    if "moe_aux" in sow:
        np.testing.assert_allclose(float(sow["moe_aux"]),
                                   float(inter["moe_aux"]), rtol=1e-6)
    cap = max(1, int(factor * (k if router == "topk" else 1) * 16 / 4))
    load = _np(sow["moe_expert_load"])
    assert load.max() <= 2 * cap and float(sow["moe_slot_max"]) <= 1
    if factor < 1:   # the capacity bound dropped some assignments
        assert load.sum() < 2 * 16 * k


# ------------------------------------------------------------ the LM

def _jstate(jcfg, seed=0):
    return jcreate_lm_state(jbuild_lm(jcfg, use_flash=False),
                            jax.random.key(seed), (1, 16))


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
def test_moe_lm_logits_and_intermediates_match_jax(router):
    jcfg, tcfg = _cfgs(moe_top_k=2, moe_router=router)
    jstate = _jstate(jcfg)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jstate.params),
                              device="cpu")
    assert "moe" in tparams["block_1"] and "up" not in tparams["block_1"]
    assert tparams["block_1"]["moe"]["router"]["kernel"].dtype == torch.float32
    tokens = np.random.default_rng(1).integers(0, 64, (2, 24)).astype(
        np.int32)
    want, mods = jax.jit(lambda p, t: jstate.apply_fn(
        {"params": p}, t, mutable=["intermediates"]))(jstate.params,
                                                      jnp.asarray(tokens))
    with torch.no_grad():
        got, inter = build_lm(tcfg, use_flash=False)(
            tparams, torch.from_numpy(tokens).long(),
            return_intermediates=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL32)
    jinter = mods["intermediates"]["block_1"]["moe"]
    assert sorted(inter) == ["block_1"]
    assert sorted(inter["block_1"]) == sorted(jinter)
    for key, val in inter["block_1"].items():
        np.testing.assert_allclose(_np(val), np.asarray(jinter[key][0]),
                                   rtol=1e-6, atol=0)


class RecordingAdamW(AdamW):
    """AdamW that keeps the gradients of its last update."""

    def update(self, grads, opt_state, params):
        object.__setattr__(self, "grads", [g.clone() for g in grads])
        return super().update(grads, opt_state, params)


# (name, cfg overrides, the step's moe_aux_weight, the weight it must use)
STEP_CASES = [
    ("cfg_weight", {"moe_aux_weight": 0.3}, None, 0.3),
    ("override", {"moe_aux_weight": 0.3}, 2.0, 2.0),
    ("fused_loss", {"loss_impl": "fused", "ce_block": 16}, None, 0.01),
]


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: c[0])
def test_moe_train_step_loss_and_grads_match_jax(case):
    _, extra, weight, used = case
    jcfg, tcfg = _cfgs(moe_top_k=2, **extra)
    jstate = _jstate(jcfg)
    tokens = np.random.default_rng(2).integers(0, 64, (2, 32)).astype(
        np.int32)

    def loss_fn(params):
        out, mods = jstate.apply_fn(
            {"params": params}, jnp.asarray(tokens),
            return_hidden=tcfg.loss_impl == "fused",
            mutable=["intermediates"])
        if tcfg.loss_impl == "fused":
            from kubeflow_tpu.ops.cross_entropy import fused_lm_loss

            main = fused_lm_loss(out, params["embed"]["embedding"],
                                 jnp.asarray(tokens), None, block=16)
        else:
            main = jlm_loss(out, jnp.asarray(tokens))
        aux = _moe_aux_total(mods["intermediates"])
        return main + used * aux, (main, aux)

    (jloss, (jmain, jaux)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jstate.params)
    assert float(jaux) > 0.5   # ~1 per MoE block at balance
    tx = RecordingAdamW(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate),
                                  apply_fn=build_lm(tcfg, use_flash=False),
                                  tx=tx, device="cpu")
    step = make_lm_train_step(moe_aux_weight=weight, cfg=tcfg)
    tstate, metrics = step(tstate, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               atol=1e-5, rtol=0)
    flat = dict(flatten(jax.tree.map(np.asarray, jgrads)))
    paths = [path for path, _ in flatten(tstate.params)]
    assert len(paths) == len(flat) and any("experts_up" in p for p in paths)
    for path, g in zip(paths, tx.grads):
        want = torch.from_numpy(np.array(flat[path]))
        err = float((g - want).norm() / want.norm())
        assert err <= 1e-4, (path, err)


def test_moe_config_trains_on_the_port_and_its_loss_falls():
    _, tcfg = _cfgs(moe_top_k=1, layers=4)
    state = create_lm_state(build_lm(tcfg), seed=0, device="cpu")
    assert "moe" in state.params["block_3"]
    assert param_count(state.params) == param_count(
        init_params(tcfg, seed=0, device="cpu"))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 64, (2, 32))).long()
    step = make_lm_train_step(cfg=tcfg)
    losses = [float(step(state, {"tokens": tokens})[1]["loss"])
              for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ------------------------------------------------------------ decode

def test_moe_forward_with_cache_and_generate_match_jax():
    jcfg, tcfg = _cfgs(moe_top_k=2)
    jparams = _jstate(jcfg).params
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    prompt = np.random.default_rng(4).integers(0, 64, (1, 12)).astype(
        np.int32)
    jfwd = jax.jit(lambda p, t, c: jforward(jcfg, p, t, c))
    jl1, jcache = jfwd(jparams, jnp.asarray(prompt), JKVCache.init(jcfg, 1, 24))
    jl2, _ = jfwd(jparams, jnp.asarray(prompt[:, :3]), jcache)
    cache = KVCache.init(tcfg, 1, 24, device="cpu")
    l1, cache = forward_with_cache(tcfg, tparams, prompt, cache,
                                   device="cpu")
    l2, _ = forward_with_cache(tcfg, tparams, prompt[:, :3], cache,
                               device="cpu")
    np.testing.assert_allclose(_np(l1), np.asarray(jl1), **TOL32)
    np.testing.assert_allclose(_np(l2), np.asarray(jl2), **TOL32)
    want = np.asarray(jgenerate(jcfg, jparams, jnp.asarray(prompt), 10))
    got = generate(tcfg, tparams, prompt, 10, device="cpu")
    assert got.tolist() == want.tolist()


def test_moe_decode_refuses_expert_choice_with_the_reference_message():
    _, tcfg = _cfgs(moe_router="expert_choice")
    params = init_params(tcfg, seed=0, device="cpu")
    prompt = [[1, 2, 3]]
    with pytest.raises(NotImplementedError, match="not causal"):
        generate(tcfg, params, prompt, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="not causal"):
        forward_with_cache(tcfg, params, prompt,
                           KVCache.init(tcfg, 1, 8, device="cpu"),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="not causal"):
        speculative_generate(tcfg, params, prompt, 4, device="cpu")
    _, topk = _cfgs()
    with pytest.raises(ValueError, match="heterogeneous"):
        stack_decode_params(topk, init_params(topk, device="cpu"))


def test_quantize_decode_params_leaves_the_moe_subtree_untouched():
    _, tcfg = _cfgs()
    params = init_params(tcfg, seed=0, device="cpu")
    qparams = quantize_decode_params(tcfg, params)
    assert qparams["block_1"]["moe"] is params["block_1"]["moe"]
    assert isinstance(qparams["block_1"]["proj"]["kernel"], Int8Linear)
    assert isinstance(qparams["block_0"]["up"]["kernel"], Int8Linear)
    prompt = [[5, 9, 11, 2, 7]]
    assert generate(tcfg, qparams, prompt, 6, device="cpu").tolist() == \
        generate(tcfg, params, prompt, 6, quantize_weights=True,
                 device="cpu").tolist()


# ------------------------------------------------------------ serving

def _requests(engine, prompts, temps, seeds, budget=6):
    events = [[] for _ in prompts]
    for i, prompt in enumerate(prompts):
        engine.submit_stream(prompt, events[i].append, max_new_tokens=budget,
                             temperature=temps[i], rng=seeds[i])
    return events


def test_moe_make_engine_falls_back_to_serialized_generate(caplog):
    _, tcfg = _cfgs(moe_top_k=2)
    params = init_params(tcfg, seed=1, device="cpu")
    with caplog.at_level("WARNING"):
        engine = make_engine(tcfg, params, max_batch=4, max_len=64,
                             spec_ngram=True, device="cpu")
    assert isinstance(engine, GenerateFallbackEngine)
    assert "fallback" in caplog.text
    assert engine.slots_total == 1 and not engine.batched
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, 64, n)] for n in (7, 12, 4)]
    temps, seeds = [0.0, 0.9, 0.0], [None, 21, None]
    events = _requests(engine, prompts, temps, seeds)
    engine.drain()
    for i, prompt in enumerate(prompts):
        want = generate(tcfg, params, [prompt], 6, temperature=temps[i],
                        rng=seeds[i], device="cpu")[0].tolist()
        assert [e["token"] for e in events[i] if "token" in e] == want
        assert events[i][-1] == {"done": True, "reason": "length",
                                 "tokens": want, "cache_hit": False}
    with pytest.raises(ValueError, match="max_len"):
        engine.submit_stream([1] * 60, lambda e: None, max_new_tokens=8)
    with pytest.raises(ValueError, match="rng"):
        engine.submit_stream([1, 2], lambda e: None, temperature=0.5)


def test_moe_fallback_engine_swaps_between_requests():
    _, tcfg = _cfgs()
    old, new = (init_params(tcfg, seed=s, device="cpu") for s in (2, 3))
    engine = make_engine(tcfg, old, max_len=64, device="cpu")
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    first = _requests(engine, [prompt], [0.0], [None])
    engine.drain()
    engine.swap_params(new)
    second = _requests(engine, [prompt], [0.0], [None])
    engine.drain()
    assert engine.swaps_total == 1
    assert first[0][-1]["tokens"] == generate(
        tcfg, old, [prompt], 6, device="cpu")[0].tolist()
    assert second[0][-1]["tokens"] == generate(
        tcfg, new, [prompt], 6, device="cpu")[0].tolist()
    assert first[0][-1]["tokens"] != second[0][-1]["tokens"]


def test_moe_fallback_engine_serves_metrics_over_the_gateway():
    _, tcfg = _cfgs()
    params = init_params(tcfg, seed=4, device="cpu")
    engine = make_engine(tcfg, params, max_len=64, device="cpu")
    gateway = InferenceGateway(engine, port=0).start()
    url = f"http://127.0.0.1:{gateway.port}"
    try:
        req = urllib.request.Request(
            url + "/v1/generate", data=json.dumps(
                {"prompt": [1, 2, 3], "max_new_tokens": 4,
                 "stream": False}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert body["tokens"] == generate(tcfg, params, [[1, 2, 3]], 4,
                                          device="cpu")[0].tolist()
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            text = r.read().decode()
        with urllib.request.urlopen(url + "/v1/status", timeout=60) as r:
            status = json.loads(r.read())
    finally:
        gateway.stop()
    assert "inference_slots_total 1.0" in text
    for phase in ("admit", "prefill", "decode", "verify", "commit"):
        assert (f'inference_batch_cycle_seconds_count{{phase="{phase}"}}'
                in text), phase
    assert status["batched"] is False


# ------------------------------------------------------ checkpoints

def _batches(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, (2, 16)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_moe_checkpoint_restores_across_packages_and_trains_on(
        tmp_path, direction):
    jcfg, tcfg = _cfgs(moe_top_k=2)
    jstep, tstep = jmake_step(cfg=jcfg), make_lm_train_step(cfg=tcfg)
    jstate, _ = jstep(_jstate(jcfg), {"tokens": jnp.asarray(_batches(0, 1)[0])})
    saved = jax.tree.map(np.asarray, jstate)
    if direction == "jax_to_port":
        jckpt.save_checkpoint(tmp_path, jstate, step=1)
        like = create_lm_state(build_lm(tcfg), seed=9, device="cpu")
        tstate = restore_checkpoint(tmp_path, like)
        jstate = jax.tree.map(jnp.asarray, saved)
    else:
        save_checkpoint(tmp_path, train_state_from_jax(tcfg, saved,
                                                       device="cpu"), step=1)
        like = _jstate(jcfg, seed=9)
        jstate = jckpt.restore_checkpoint(tmp_path, like)
        tstate = train_state_from_jax(tcfg, saved, device="cpu")
    assert tstate.step == 1 and tstate.opt_state.count == 1
    mu = tstate.opt_state.mu["block_1"]["moe"]["experts_up"]
    assert mu.dtype == torch.bfloat16 and mu.abs().sum() > 0
    np.testing.assert_array_equal(
        _np(tstate.params["block_1"]["moe"]["router"]["kernel"]),
        saved.params["block_1"]["moe"]["router"]["kernel"])
    jl, tl = [], []
    for tokens in _batches(7, 3):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(tokens).long()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)


def test_moe_bench_config_has_the_stated_parameter_count(monkeypatch):
    """bench.py's lm_moe config (8 x 1024 MHA, 8 experts every 2nd
    block), counted from shapes: the draws are empty meta tensors, so
    nothing of its 369M parameters is allocated."""
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None:
                        torch.empty(shape, device="meta"))
    cfg = LMConfig(vocab=32768, layers=8, dim=1024, heads=8, moe_experts=8,
                   moe_every=2, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device="meta")
    assert param_count(params) == 369_148_928
    assert param_count(params["block_0"]) == 12_584_960
    assert param_count(params["block_1"]) == 71_313_408


def test_spec_ngram_pod_flag_on_a_threaded_fallback_is_inert():
    """A spec flag on an MoE model leaves the fallback serving: the
    scheduler thread answers while requests arrive from another thread."""
    from kubeflow_tpu_torch.serving import Scheduler

    _, tcfg = _cfgs()
    params = init_params(tcfg, seed=6, device="cpu")
    engine = make_engine(tcfg, params, max_len=64, spec_ngram=True,
                         device="cpu")
    done = threading.Event()
    events = []

    def sink(event):
        events.append(event)
        if event.get("done"):
            done.set()

    sched = Scheduler(engine).start()
    try:
        engine.submit_stream([4, 4, 4, 4], sink, max_new_tokens=5)
        assert done.wait(60)
    finally:
        sched.stop()
    assert events[-1]["tokens"] == generate(tcfg, params, [[4, 4, 4, 4]], 5,
                                            device="cpu")[0].tolist()

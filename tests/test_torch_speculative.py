"""CPU parity of the port's speculative decoding against the JAX package
and against the port's own ``generate``.

- ``ngram_propose`` and ``NGramProposer`` return what the reference's
  return, on the cases of ``tests/test_speculative.py`` and on seeded
  random histories over a small vocabulary (so that contexts recur).
- ``speculative_generate`` (f32, tiny model, the reference's weights
  carried across by ``params_from_jax``) gives the reference's greedy
  tokens and the same ``SpecStats`` (the draft rule reads the same stale
  buffer tail), and the port's ``generate``'s tokens: greedy, seeded
  sampling, draft/ngram shapes, a budget of 1, int8 weights and an int8
  cache, bit for bit.
- Sampling noise: every draw is one ``(1, vocab)`` row, no more than the
  budget's rows are drawn, and a run whose verifies accept some drafts
  and reject others, on a model whose tokens the noise decides (vocab
  8, temperature 1), equals ``generate(rng=seed)``: drawing a verify's
  rows as one ``(T, vocab)`` call, or dropping its unemitted rows, fails
  these tests.
- ``verify_step`` gives the reference's candidates and cache rows for the
  same slots (f32, 2e-5), and each candidate equals what a chain of
  ``decode_step``s feeding the same tokens samples; ``commit_verify``
  moves only the slots that emitted.
- The spec engine's streams (greedy and sampled, mixed with lockstep
  neighbours) equal ``generate``; its verify and commit histograms count
  each spec cycle and ``/metrics`` carries all five phase series; a
  rolling model asked for speculation serves lockstep with a warning.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import LMConfig as JConfig
from kubeflow_tpu.models import build_lm, create_lm_state
from kubeflow_tpu.models import generate as jgenerate
from kubeflow_tpu.models import serving as jserving
from kubeflow_tpu.models.speculative import NGramProposer as JProposer
from kubeflow_tpu.models.speculative import ngram_propose as jngram_propose
from kubeflow_tpu.models.speculative import (
    speculative_generate as jspeculative_generate,
)
from kubeflow_tpu_torch.models import speculative as spec_mod
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.decoding import (
    generate,
    quantize_decode_params,
    stack_decode_params,
)
from kubeflow_tpu_torch.models.serving import (
    BatchState,
    commit_verify,
    decode_step,
    prefill_slot,
    verify_step,
)
from kubeflow_tpu_torch.models.speculative import (
    NGramProposer,
    SpecStats,
    ngram_propose,
    speculative_generate,
)
from kubeflow_tpu_torch.models.transformer import LMConfig, init_params
from kubeflow_tpu_torch.serving import (
    InferenceGateway,
    StreamingBatcher,
    make_engine,
)

TOL32 = dict(atol=2e-5, rtol=2e-5)
SMALL = dict(vocab=128, layers=2, dim=64, heads=4, kv_heads=2)


@pytest.fixture(scope="module")
def lm():
    jcfg = JConfig(dtype=jnp.float32, **SMALL)
    tcfg = LMConfig(dtype=torch.float32, **SMALL)
    jparams = create_lm_state(build_lm(jcfg, use_flash=False),
                              jax.random.key(0), (1, 16)).params
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _repetitive(seed, period, repeats, vocab=128):
    base = np.random.default_rng(seed).integers(0, vocab, period)
    return [[int(t) for t in base] * repeats]


def _gen(cfg, params, prompt, n, **kw):
    return generate(cfg, params, prompt, n, device="cpu", **kw)[0].tolist()


# ------------------------------------------------------------ proposers

# (buffer, count, n, k): tests/test_speculative.py's TestNGramPropose.
PROPOSE_CASES = [
    ([1, 2, 3, 9, 1, 2, 3, 7, 8, 1, 2, 3, 0, 0], 12, 3, 2),
    ([5, 6, 7, 8, 0, 0], 4, 2, 3),
    ([4, 5, 6, 0, 0], 3, 2, 2),
    ([1, 2, 9, 9, 1, 2, 3, 3], 4, 2, 1),
]


def _random_buffers():
    rng = np.random.default_rng(11)
    for _ in range(24):
        length = int(rng.integers(6, 40))
        buf = [int(t) for t in rng.integers(0, 4, length)]
        yield (buf, int(rng.integers(1, length + 1)),
               int(rng.integers(1, 4)), int(rng.integers(1, min(6, length))))


@pytest.mark.parametrize("case", PROPOSE_CASES + list(_random_buffers()),
                         ids=lambda c: f"count{c[1]}_n{c[2]}_k{c[3]}")
def test_ngram_propose_matches_jax(case):
    buf, count, n, k = case
    want, wfound = jngram_propose(jnp.asarray(buf, jnp.int32),
                                  jnp.int32(count), n=n, k=k)
    got, found = ngram_propose(torch.tensor(buf, dtype=torch.int32), count,
                               n=n, k=k)
    assert got.tolist() == np.asarray(want).tolist()
    assert bool(found) == bool(wfound)


PROPOSER_CASES = [
    (3, 4, [1, 2, 3, 9, 1, 2, 3, 7, 7, 1, 2, 3]),
    (3, 2, [3, 8, 9, 3]),
    (2, 5, [1, 2, 7, 1, 2]),
    (3, 3, [4]),
]


def _random_histories():
    rng = np.random.default_rng(12)
    for _ in range(12):
        yield (int(rng.integers(1, 5)), int(rng.integers(1, 9)),
               [int(t) for t in rng.integers(0, 5, int(rng.integers(1, 30)))])


@pytest.mark.parametrize("case", PROPOSER_CASES + list(_random_histories()),
                         ids=lambda c: f"n{c[0]}_k{c[1]}_len{len(c[2])}")
def test_ngram_proposer_matches_jax(case):
    n, k, history = case
    assert NGramProposer(n=n, k=k).propose(history) == \
        JProposer(n=n, k=k).propose(history)


def test_proposer_refuses_zero_sizes():
    with pytest.raises(ValueError, match=">= 1"):
        NGramProposer(n=0)
    with pytest.raises(ValueError, match=">= 1"):
        NGramProposer(k=0)


# ------------------------------------------------------------ generate

def test_greedy_tokens_and_stats_match_jax_speculative_generate(lm):
    jcfg, tcfg, jparams, tparams = lm
    prompt = _repetitive(0, 6, 3)
    want, wstats = jspeculative_generate(jcfg, jparams,
                                         jnp.asarray(prompt, jnp.int32), 20,
                                         return_stats=True)
    got, stats = speculative_generate(tcfg, tparams, prompt, 20,
                                      return_stats=True, device="cpu")
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist()[0] == _gen(tcfg, tparams, prompt, 20)
    assert (stats.verify_calls, stats.drafted, stats.accepted,
            stats.tokens) == (int(wstats.verify_calls), int(wstats.drafted),
                              int(wstats.accepted), wstats.tokens)
    assert stats.verify_calls < 20 and stats.accepted > 0
    assert stats.accept_rate == wstats.accept_rate
    assert stats.tokens_per_verify == wstats.tokens_per_verify


def test_greedy_random_prompt_matches_jax_generate(lm):
    jcfg, tcfg, jparams, tparams = lm
    prompt = [[int(t) for t in np.random.default_rng(1).integers(0, 128, 11)]]
    want = np.asarray(jgenerate(jcfg, jparams, jnp.asarray(prompt, jnp.int32),
                                9))
    assert speculative_generate(tcfg, tparams, prompt, 9,
                                device="cpu").tolist() == want.tolist()


@pytest.mark.parametrize("draft,ngram", [(1, 1), (2, 3), (4, 2), (8, 3),
                                         (12, 1)])
def test_draft_shape_never_changes_output(lm, draft, ngram):
    _, tcfg, _, tparams = lm
    prompt = _repetitive(2, 4, 4)
    out = speculative_generate(tcfg, tparams, prompt, 13, draft=draft,
                               ngram=ngram, device="cpu")
    assert out.tolist()[0] == _gen(tcfg, tparams, prompt, 13)
    assert out.dtype == torch.int32 and tuple(out.shape) == (1, 13)


@pytest.mark.parametrize("temperature,seed", [(0.8, 42), (1.5, 7)])
def test_seeded_sampling_equals_generate(lm, temperature, seed):
    _, tcfg, _, tparams = lm
    prompt = _repetitive(3, 5, 3)
    want = _gen(tcfg, tparams, prompt, 16, temperature=temperature, rng=seed)
    out = speculative_generate(tcfg, tparams, prompt, 16,
                               temperature=temperature, rng=seed,
                               device="cpu")
    assert out.tolist()[0] == want
    gen = torch.Generator().manual_seed(seed)
    assert speculative_generate(tcfg, tparams, prompt, 16,
                                temperature=temperature, rng=gen,
                                device="cpu").tolist()[0] == want


def _noise_decided_model():
    """vocab 8 with logits of order one: at temperature 1 the Gumbel rows
    decide the tokens, and n-gram drafts over 8 tokens are often right."""
    cfg = LMConfig(vocab=8, layers=2, dim=32, heads=4, kv_heads=2,
                   dtype=torch.float32)
    return cfg, init_params(cfg, seed=5, device="cpu")


def test_partly_accepted_verifies_carry_their_unemitted_noise_rows():
    cfg, params = _noise_decided_model()
    prompt = [[1, 2, 3, 1, 2, 3, 1, 2]]
    for seed in (3, 4, 5):
        want = _gen(cfg, params, prompt, 48, temperature=1.0, rng=seed)
        out, stats = speculative_generate(
            cfg, params, prompt, 48, temperature=1.0, rng=seed, draft=4,
            ngram=2, return_stats=True, device="cpu")
        assert out.tolist()[0] == want, seed
        # Some drafts accepted, some rejected: rows were carried over.
        assert 0 < stats.accepted < stats.drafted
        assert stats.verify_calls < 47


def test_noise_is_drawn_one_row_at_a_time_within_the_budget(monkeypatch):
    cfg, params = _noise_decided_model()
    shapes = []
    real = spec_mod.gumbel_noise

    def spy(gen, shape, device):
        shapes.append(tuple(shape))
        return real(gen, shape, device)

    monkeypatch.setattr(spec_mod, "gumbel_noise", spy)
    speculative_generate(cfg, params, [[1, 2, 3, 1, 2]], 20,
                         temperature=1.0, rng=9, draft=6, device="cpu")
    # The first token's row, then at most budget - 1 decode rows.
    assert shapes == [(1, cfg.vocab)] * 20


def test_budget_of_one_is_the_prefill_token(lm):
    _, tcfg, _, tparams = lm
    prompt = [[int(t) for t in np.random.default_rng(4).integers(0, 128, 7)]]
    out, stats = speculative_generate(tcfg, tparams, prompt, 1,
                                      return_stats=True, device="cpu")
    assert out.tolist()[0] == _gen(tcfg, tparams, prompt, 1)
    assert stats == SpecStats(0, 0, 0, 1)


def test_int8_weights_compose(lm):
    _, tcfg, _, tparams = lm
    prompt = _repetitive(6, 4, 3)
    want = _gen(tcfg, quantize_decode_params(tcfg, tparams), prompt, 10)
    assert speculative_generate(tcfg, tparams, prompt, 10,
                                quantize_weights=True,
                                device="cpu").tolist()[0] == want


def test_int8_cache_composes(lm):
    """Rejected drafts leave int8 rows and their scales in the cache; the
    next verify rewrites both."""
    _, tcfg, _, tparams = lm
    prompt = _repetitive(7, 4, 3)
    want = _gen(tcfg, tparams, prompt, 12, quantize_cache=True)
    out, stats = speculative_generate(tcfg, tparams, prompt, 12,
                                      quantize_cache=True, return_stats=True,
                                      device="cpu")
    assert out.tolist()[0] == want
    assert stats.accepted < stats.drafted


def test_windowed_model_with_an_ample_window_keeps_a_linear_cache(lm):
    _, _, _, _ = lm
    cfg = LMConfig(dtype=torch.float32, attn_window=64, **SMALL)
    params = init_params(cfg, seed=2, device="cpu")
    prompt = _repetitive(9, 4, 3)
    assert speculative_generate(cfg, params, prompt, 8,
                                device="cpu").tolist()[0] == \
        _gen(cfg, params, prompt, 8)


def test_refusals(lm):
    _, tcfg, _, tparams = lm
    prompt = [[1, 2, 3, 4, 5, 6]]
    with pytest.raises(ValueError, match="per-sequence"):
        speculative_generate(tcfg, tparams, prompt * 2, 4, device="cpu")
    with pytest.raises(ValueError, match="categorical"):
        speculative_generate(tcfg, tparams, prompt, 4, temperature=0.5,
                             device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        speculative_generate(tcfg, tparams, prompt, 0, device="cpu")
    with pytest.raises(ValueError, match="draft and ngram"):
        speculative_generate(tcfg, tparams, prompt, 4, draft=0, device="cpu")
    with pytest.raises(ValueError, match="draft and ngram"):
        speculative_generate(tcfg, tparams, prompt, 4, ngram=0, device="cpu")
    with pytest.raises(ValueError, match="raw training params"):
        speculative_generate(tcfg, stack_decode_params(tcfg, tparams),
                             prompt, 4, device="cpu")
    windowed = dataclasses.replace(tcfg, attn_window=8)
    with pytest.raises(ValueError, match="linear KV cache"):
        speculative_generate(windowed, tparams, prompt, 32, device="cpu")
    moe = dataclasses.replace(tcfg, moe_experts=4,
                              moe_router="expert_choice")
    with pytest.raises(NotImplementedError, match="expert-choice"):
        speculative_generate(moe, tparams, prompt, 4, device="cpu")


# ------------------------------------------------------------ verify

def _two_slot_states(lm, prompts, with_jax=True):
    """The port's BatchState (and the reference's, ``with_jax``) with
    ``prompts`` prefilled greedily into slots 0 and 1 (capacity 64)."""
    jcfg, tcfg, jparams, tparams = lm
    jstate = jserving.BatchState.init(jcfg, 2, 64) if with_jax else None
    tstate = BatchState.init(tcfg, 2, 64, device="cpu")
    firsts = []
    prefill = jax.jit(lambda p, st, slot, prompt: jserving.prefill_slot(
        jcfg, p, st, slot, prompt, jnp.float32(0.0), jax.random.key(0)))
    for slot, prompt in enumerate(prompts):
        tstate, tfirst = prefill_slot(tcfg, tparams, tstate, slot,
                                      torch.tensor([prompt]), 0.0)
        if with_jax:
            jstate, jfirst = prefill(jparams, jstate, slot,
                                     jnp.asarray([prompt], jnp.int32))
            assert int(jfirst) == int(tfirst)
        firsts.append(int(tfirst))
    return jstate, tstate, firsts


def test_verify_step_matches_jax_and_a_chain_of_decode_steps(lm):
    jcfg, tcfg, jparams, tparams = lm
    rng = np.random.default_rng(8)
    prompts = [[int(t) for t in rng.integers(0, 128, n)] for n in (9, 14)]
    jstate, tstate, firsts = _two_slot_states(lm, prompts)
    t = 5
    drafts = rng.integers(0, 128, (2, t - 1))
    tokens = np.concatenate([np.asarray(firsts)[:, None], drafts], axis=1)
    jnew, jcand = jax.jit(lambda p, st, tok: jserving.verify_step(
        jcfg, p, st, tok))(jparams, jstate, jnp.asarray(tokens, jnp.int32))
    chain = dataclasses.replace(tstate, **{
        name: getattr(tstate, name).clone() for name in
        ("k", "v", "pos", "last", "active", "temp")})
    tnew, cand = verify_step(tcfg, tparams, tstate, torch.from_numpy(tokens))
    assert cand.tolist() == np.asarray(jcand).tolist()
    assert torch.equal(tnew.pos, torch.tensor([9, 14], dtype=torch.int32))
    for b, p in enumerate((9, 14)):
        np.testing.assert_allclose(
            tnew.k[:, b, :, p:p + t].numpy(),
            np.asarray(jnew.k)[:, b, :, p:p + t], **TOL32)
        np.testing.assert_allclose(
            tnew.v[:, b, :, p:p + t].numpy(),
            np.asarray(jnew.v)[:, b, :, p:p + t], **TOL32)
    # The same tokens fed one at a time through decode_step.
    for i in range(t):
        chain.last.copy_(torch.from_numpy(tokens[:, i]).int())
        chain, nxt = decode_step(tcfg, tparams, chain)
        assert nxt.tolist() == cand[:, i].tolist(), i
    np.testing.assert_allclose(chain.k[:, :, :, :20].numpy(),
                               tnew.k[:, :, :, :20].numpy(), **TOL32)


def test_verify_step_samples_each_position_with_its_own_noise_row(lm):
    _, tcfg, _, tparams = lm
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(0, 128, n)] for n in (6, 10)]
    _, tstate, firsts = _two_slot_states(lm, prompts, with_jax=False)
    tstate.temp[1] = 0.7
    tokens = torch.tensor([[firsts[0], 3, 4], [firsts[1], 5, 6]])
    noise = torch.from_numpy(rng.gumbel(size=(2, 3, 128)).astype(np.float32))
    chain = dataclasses.replace(tstate, **{
        name: getattr(tstate, name).clone() for name in
        ("k", "v", "pos", "last", "active", "temp")})
    _, cand = verify_step(tcfg, tparams, tstate, tokens, noise)
    for i in range(3):
        chain.last.copy_(tokens[:, i].int())
        chain, nxt = decode_step(tcfg, tparams, chain, noise[:, i])
        assert nxt.tolist() == cand[:, i].tolist(), i


def test_commit_verify_moves_only_the_slots_that_emitted(lm):
    _, tcfg, _, _ = lm
    state = BatchState.init(tcfg, 3, 64, device="cpu")
    state.pos.copy_(torch.tensor([5, 9, 12], dtype=torch.int32))
    state.last.copy_(torch.tensor([1, 2, 3], dtype=torch.int32))
    state = commit_verify(state, [2, 0, 4], [7, 8, 9])
    assert state.pos.tolist() == [7, 9, 16]
    assert state.last.tolist() == [7, 2, 9]


def test_verify_step_refuses_rolling_slots_and_moe(lm):
    _, tcfg, _, tparams = lm
    state = BatchState.init(tcfg, 1, 64, device="cpu")
    with pytest.raises(ValueError, match="linear slots"):
        verify_step(tcfg, tparams, state, torch.zeros((1, 3)), rolling=True)
    moe = dataclasses.replace(tcfg, moe_experts=4)
    with pytest.raises(NotImplementedError, match="MoE"):
        verify_step(moe, tparams, state, torch.zeros((1, 3)))


# ------------------------------------------------------------ engine

def _serve(engine, prompts, temps, seeds, budgets):
    events = [[] for _ in prompts]
    for i, prompt in enumerate(prompts):
        engine.submit_stream(prompt, events[i].append,
                             max_new_tokens=budgets[i], temperature=temps[i],
                             rng=seeds[i])
    engine.drain()
    return [ev[-1]["tokens"] for ev in events], events


def test_spec_engine_streams_equal_generate_greedy_and_sampled(lm):
    _, tcfg, _, tparams = lm
    prompts = (_repetitive(10, 5, 3) + _repetitive(11, 3, 4)
               + [[int(t) for t in np.random.default_rng(12).integers(
                   0, 128, 9)]] + _repetitive(13, 4, 2))
    temps, seeds = [0.0, 0.9, 0.0, 1.2], [None, 31, None, 32]
    budgets = [14, 11, 7, 16]
    engine = make_engine(tcfg, tparams, max_batch=2, max_len=64,
                         spec_ngram=True, spec_draft=4, spec_ngram_n=2,
                         device="cpu")
    assert isinstance(engine, StreamingBatcher) and engine.spec_ngram
    assert engine.reserve_slack == max(engine.step_chunk, 4)
    outs, events = _serve(engine, prompts, temps, seeds, budgets)
    for i, prompt in enumerate(prompts):
        want = _gen(tcfg, tparams, [prompt], budgets[i],
                    temperature=temps[i], rng=seeds[i])
        assert outs[i] == want, i
        assert [e["token"] for e in events[i] if "token" in e] == want
    assert engine.spec_verifies_total == engine.cycle_seconds["verify"].count
    assert engine.cycle_seconds["commit"].count == engine.spec_verifies_total
    assert 0 < engine.spec_accepted_total < engine.spec_drafted_total
    # A verify retires more than one token a slot on repetitive text.
    assert engine.spec_verifies_total < sum(budgets) - len(prompts)


def test_spec_engine_on_an_int8_cache_equals_generate(lm):
    """Verify writes int8 rows and their scales; rejected rows are
    rewritten by the next verify."""
    _, tcfg, _, tparams = lm
    prompts = _repetitive(16, 4, 3) + _repetitive(17, 5, 2)
    engine = make_engine(tcfg, tparams, max_batch=2, max_len=64,
                         quantize_cache=True, spec_ngram=True, spec_draft=3,
                         device="cpu")
    outs, _ = _serve(engine, prompts, [0.0, 0.7], [None, 41], [10, 9])
    for i, prompt in enumerate(prompts):
        assert outs[i] == _gen(tcfg, tparams, [prompt], (10, 9)[i],
                               temperature=(0.0, 0.7)[i],
                               rng=(None, 41)[i], quantize_cache=True)
    assert engine.spec_drafted_total > engine.spec_accepted_total


def test_spec_engine_admission_reserves_the_draft_overshoot(lm):
    _, tcfg, _, tparams = lm
    engine = make_engine(tcfg, tparams, max_batch=1, max_len=64,
                         spec_ngram=True, spec_draft=16, device="cpu")
    cap = engine.capacity
    with pytest.raises(ValueError, match="write slack \\(16\\)"):
        engine.submit_stream([1] * (cap - 16), lambda e: None,
                             max_new_tokens=8)
    engine.submit_stream([1] * (cap - 24), lambda e: None, max_new_tokens=8)
    lockstep = make_engine(tcfg, tparams, max_batch=1, max_len=64,
                           device="cpu")
    lockstep.submit_stream([1] * (cap - 16), lambda e: None,
                           max_new_tokens=8)


def test_metrics_carry_all_five_cycle_phases_and_spec_cycles_count(lm):
    _, tcfg, _, tparams = lm
    engine = make_engine(tcfg, tparams, max_batch=2, max_len=64,
                         spec_ngram=True, spec_draft=3, device="cpu")
    gateway = InferenceGateway(engine, port=0).start()
    url = f"http://127.0.0.1:{gateway.port}"
    try:
        req = urllib.request.Request(
            url + "/v1/generate", data=json.dumps(
                {"prompt": _repetitive(14, 3, 3)[0], "max_new_tokens": 9,
                 "stream": False}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["tokens"] == _gen(
                tcfg, tparams, _repetitive(14, 3, 3), 9)
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            text = r.read().decode()
    finally:
        gateway.stop()
    counts = {}
    for line in text.splitlines():
        if line.startswith("inference_batch_cycle_seconds_count{"):
            phase = line.split('phase="')[1].split('"')[0]
            counts[phase] = float(line.split()[-1])
    assert sorted(counts) == ["admit", "commit", "decode", "prefill",
                              "verify"]
    assert counts["verify"] >= 1 and counts["verify"] == counts["commit"]


def test_lockstep_engine_still_exports_zero_verify_and_commit(lm):
    _, tcfg, _, tparams = lm
    engine = make_engine(tcfg, tparams, max_batch=2, max_len=64,
                         device="cpu")
    _serve(engine, [[1, 2, 3]], [0.0], [None], [5])
    assert sorted(engine.cycle_seconds) == ["admit", "commit", "decode",
                                            "prefill", "verify"]
    assert engine.cycle_seconds["verify"].count == 0
    assert engine.cycle_seconds["commit"].count == 0
    assert engine.cycle_seconds["decode"].count >= 1


def test_rolling_model_degrades_to_lockstep_with_a_warning(lm, caplog):
    _, _, _, _ = lm
    cfg = LMConfig(dtype=torch.float32, attn_window=8, **SMALL)
    params = init_params(cfg, seed=3, device="cpu")
    with caplog.at_level(logging.WARNING):
        engine = make_engine(cfg, params, max_batch=2, max_len=64,
                             spec_ngram=True, device="cpu")
    assert isinstance(engine, StreamingBatcher) and not engine.spec_ngram
    assert engine.rolling and "lockstep" in caplog.text
    prompt = _repetitive(15, 4, 4)
    outs, _ = _serve(engine, prompt, [0.0], [None], [12])
    assert outs[0] == _gen(cfg, params, prompt, 12)
    with pytest.raises(ValueError, match="linear slots"):
        StreamingBatcher(cfg, params, max_batch=2, max_len=64,
                         spec_ngram=True, device="cpu")

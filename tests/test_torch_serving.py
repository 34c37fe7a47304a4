"""CPU parity of the port's batcher and streaming engine.

Greedy tokens compare EXACTLY against the JAX package's
``ContinuousBatcher``/``generate`` (f32, tiny model, same weights via
``params_from_jax``). Sampling cannot share a stream with
``jax.random``, so it is held two ways: ``_sample`` against
``jnp.argmax(logits / t + g)`` with the same numpy Gumbel noise ``g``,
and the batcher and engine against the port's own ``generate`` with the
same seed (exact tokens).
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import LMConfig as JConfig
from kubeflow_tpu.models import build_lm, create_lm_state
from kubeflow_tpu.models import generate as jgenerate
from kubeflow_tpu.models.serving import ContinuousBatcher as JBatcher
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.decoding import generate
from kubeflow_tpu_torch.models.serving import ContinuousBatcher, _sample
from kubeflow_tpu_torch.models.transformer import LMConfig
from kubeflow_tpu_torch.serving import (
    QueueFull,
    Scheduler,
    StreamingBatcher,
    make_engine,
)

SMALL = dict(vocab=128, layers=2, dim=64, heads=4, kv_heads=2)


def _setup(seed=0, **kw):
    fields = {**SMALL, **kw}
    jcfg = JConfig(dtype=jnp.float32, **fields)
    tcfg = LMConfig(dtype=torch.float32, **fields)
    model = build_lm(jcfg, use_flash=False)
    jparams = create_lm_state(model, jax.random.key(seed), (1, 16)).params
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(seed, lengths, vocab=128):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]


def _port_generate(cfg, params, prompt, n, **kw):
    return generate(cfg, params, [prompt], n, device="cpu", **kw)[0].tolist()


def test_sample_matches_jax_argmax_with_shared_noise():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 50)).astype(np.float32) * 3
    noise = rng.gumbel(size=(4, 50)).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.0, 1.5], np.float32)
    out = _sample(torch.from_numpy(logits), torch.from_numpy(temp),
                  torch.from_numpy(noise))
    safe = np.where(temp > 0, temp, 1.0)[:, None]
    drawn = jnp.argmax(jnp.asarray(logits) / safe + jnp.asarray(noise), -1)
    want = np.where(temp > 0, np.asarray(drawn), logits.argmax(-1))
    assert out.tolist() == want.tolist()
    greedy = _sample(torch.from_numpy(logits), torch.from_numpy(temp))
    assert greedy.tolist() == logits.argmax(-1).tolist()


@pytest.mark.parametrize("variant", [
    # (name, cfg extras, batcher kwargs, lengths/budgets)
    ("ragged_chunk1", {}, {"step_chunk": 1}),
    ("ragged_chunk5", {}, {"step_chunk": 5}),
    ("rolling_slots", {"attn_window": 8}, {"step_chunk": 3}),
    ("int8_kv", {}, {"step_chunk": 4, "quantize_cache": True}),
], ids=lambda v: v[0])
def test_batcher_matches_jax_batcher_and_generate(variant):
    _, extra, kwargs = variant
    jcfg, tcfg, jparams, tparams = _setup(seed=1, **extra)
    budgets = [8, 3, 12, 6, 9]
    prompts = _prompts(1, [5, 11, 7, 16, 3])
    jb = JBatcher(jcfg, jparams, max_batch=2, max_len=64, **kwargs)
    tb = ContinuousBatcher(tcfg, tparams, max_batch=2, max_len=64,
                           device="cpu", **kwargs)
    jids = [jb.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    tids = [tb.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    jres, tres = jb.run(), tb.run()
    for jid, tid, p, b in zip(jids, tids, prompts, budgets):
        assert tres[tid] == jres[jid]
        if not kwargs.get("quantize_cache"):
            ref = jgenerate(jcfg, jparams, jnp.asarray([p], jnp.int32), b)
            assert tres[tid] == np.asarray(ref[0]).tolist()


def test_batcher_eos_frees_the_slot_early():
    jcfg, tcfg, jparams, tparams = _setup(seed=2)
    prompt, prompt2 = _prompts(2, [9, 6])
    ref = _port_generate(tcfg, tparams, prompt, 16)
    eos = ref[4]
    cut = ref[:ref.index(eos) + 1]
    tb = ContinuousBatcher(tcfg, tparams, max_batch=1, max_len=64,
                           eos_token=eos, device="cpu")
    rid, rid2 = tb.submit(prompt, 16), tb.submit(prompt2, 4)
    jb = JBatcher(jcfg, jparams, max_batch=1, max_len=64, eos_token=eos)
    jid, jid2 = jb.submit(prompt, 16), jb.submit(prompt2, 4)
    tres, jres = tb.run(), jb.run()
    assert tres[rid] == cut == jres[jid]
    assert tres[rid2] == jres[jid2]


def test_sampled_batcher_matches_port_generate_with_the_same_seed():
    _, tcfg, _, tparams = _setup(seed=3)
    prompts = _prompts(3, [7, 12, 4])
    tb = ContinuousBatcher(tcfg, tparams, max_batch=2, max_len=64,
                           step_chunk=3, device="cpu")
    ids = [tb.submit(prompts[0], 9, temperature=0.9, rng=5),
           tb.submit(prompts[1], 6),
           tb.submit(prompts[2], 11, temperature=1.3, rng=6)]
    res = tb.run()
    assert res[ids[0]] == _port_generate(tcfg, tparams, prompts[0], 9,
                                         temperature=0.9, rng=5)
    assert res[ids[1]] == _port_generate(tcfg, tparams, prompts[1], 6)
    assert res[ids[2]] == _port_generate(tcfg, tparams, prompts[2], 11,
                                         temperature=1.3, rng=6)


def test_batcher_validation():
    _, tcfg, _, tparams = _setup()
    tb = ContinuousBatcher(tcfg, tparams, max_batch=1, max_len=32,
                           device="cpu")
    with pytest.raises(ValueError, match="exceeds capacity"):
        tb.submit(list(range(1, 200)), max_new_tokens=100)
    with pytest.raises(ValueError, match="empty"):
        tb.submit([])
    with pytest.raises(ValueError, match="rng"):
        tb.submit([1, 2], temperature=0.5)
    moe = LMConfig(moe_experts=4, **SMALL)
    with pytest.raises(NotImplementedError, match="MoE"):
        ContinuousBatcher(moe, tparams, max_batch=1, max_len=32,
                          device="cpu")


# ----------------------------------------------------------- the engine


class _Collector:
    def __init__(self, n):
        self.events = [[] for _ in range(n)]
        self.done = [threading.Event() for _ in range(n)]

    def sink(self, i):
        def push(event):
            self.events[i].append(event)
            if event.get("done"):
                self.done[i].set()
        return push

    def final(self, i):
        return next(e for e in self.events[i] if e.get("done"))


def test_engine_with_scheduler_answers_requests_like_generate():
    """Streaming engine + Scheduler thread on the CPU: greedy and sampled
    streams, an exact prefix-cache hit, an extended-prefix hit, a
    chunked prefill; every stream equals generate()'s tokens, and the
    greedy ones the JAX package's."""
    jcfg, tcfg, jparams, tparams = _setup(seed=4)
    base = _prompts(4, [20, 9, 30])
    prompts = [base[0], base[1], base[0], base[1] + [5, 6, 7], base[2],
               base[1] + [5, 6, 7, 8]]
    temps = [0.0, 0.0, 0.0, 0.8, 0.0, 0.0]
    seeds = [None, None, None, 21, None, None]
    engine = make_engine(tcfg, tparams, max_batch=3, max_len=128,
                         step_chunk=4, prefill_chunk_tokens=16,
                         device="cpu")
    col = _Collector(len(prompts))
    sched = Scheduler(engine).start()
    try:
        for i, p in enumerate(prompts):
            engine.submit_stream(p, col.sink(i), max_new_tokens=7,
                                 temperature=temps[i], rng=seeds[i])
        for ev in col.done:
            assert ev.wait(120)
    finally:
        sched.stop()
    assert not sched.alive and sched.failures_total == 0
    for i, p in enumerate(prompts):
        final = col.final(i)
        streamed = [e["token"] for e in col.events[i] if "token" in e]
        assert final["tokens"] == streamed
        assert final["tokens"] == _port_generate(
            tcfg, tparams, p, 7, temperature=temps[i], rng=seeds[i])
        if temps[i] == 0.0:
            ref = jgenerate(jcfg, jparams, jnp.asarray([p], jnp.int32), 7)
            assert final["tokens"] == np.asarray(ref[0]).tolist()
    hits = [col.final(i)["cache_hit"] for i in range(len(prompts))]
    assert hits[2] and hits[3] and hits[5]
    assert engine.chunked_admissions_total >= 2
    assert engine.prefix_cache.hits >= 3
    assert len(engine.recorder) > 0
    assert engine.recorder.snapshots()[-1]["kind"] == "serve_cycle"
    assert engine.cycle_seconds["decode"].count > 0
    assert set(engine.profiler.compact()) >= {"prefill", "decode"}


def test_shared_prefix_entries_are_cloned_before_in_place_writes():
    """A, then B = A + s1 and C = A + s2 (both extend A's cached KV), then
    D = B exactly: the port writes caches in place, so B's entry must not
    share storage that C's suffix write lands in. Every stream equals
    generate()."""
    _, tcfg, _, tparams = _setup(seed=5)
    a = _prompts(5, [12])[0]
    prompts = [a, a + [1, 2, 3, 4], a + [9, 8, 7, 6], a + [1, 2, 3, 4]]
    engine = StreamingBatcher(tcfg, tparams, max_batch=1, max_len=64,
                              step_chunk=2, device="cpu")
    col = _Collector(len(prompts))
    for i, p in enumerate(prompts):
        engine.submit_stream(p, col.sink(i), max_new_tokens=5)
    engine.drain()
    for i, p in enumerate(prompts):
        assert col.final(i)["tokens"] == _port_generate(tcfg, tparams, p, 5)
    assert [col.final(i)["cache_hit"] for i in range(4)] == [
        False, True, True, True]


def test_engine_sheds_validates_and_degrades():
    _, tcfg, _, tparams = _setup(seed=6)
    engine = StreamingBatcher(tcfg, tparams, max_batch=1, max_len=64,
                              max_pending=2, device="cpu")
    engine.submit_stream([1, 2], lambda e: None, max_new_tokens=2)
    engine.submit_stream([3, 4], lambda e: None, max_new_tokens=2)
    with pytest.raises(QueueFull):
        engine.submit_stream([5], lambda e: None, max_new_tokens=2)
    assert engine.pending() == 2
    with pytest.raises(RuntimeError, match="submit_stream"):
        engine.submit([1])
    with pytest.raises(RuntimeError, match="step_cycle"):
        engine.run()
    engine.drain()
    assert engine.pending() == 0
    # Speculative decoding is served (tests/test_torch_speculative.py
    # holds its streams); a rolling model degrades to lockstep.
    assert make_engine(tcfg, tparams, spec_ngram=True,
                       device="cpu").spec_ngram
    _, wcfg, _, wparams = _setup(seed=6, attn_window=8)
    rolling = make_engine(wcfg, wparams, max_batch=1, max_len=64,
                          prefill_chunk_tokens=4, spec_ngram=True,
                          device="cpu")
    assert rolling.rolling and rolling.prefill_chunk_tokens is None
    assert rolling.prefix_cache is None and not rolling.spec_ngram


def test_hot_swap_applies_between_cycles_and_clears_the_prefix_cache():
    _, tcfg, _, tparams = _setup(seed=7)
    _, _, _, other = _setup(seed=8)
    engine = StreamingBatcher(tcfg, tparams, max_batch=1, max_len=64,
                              device="cpu")
    prompt = _prompts(7, [6])[0]
    col = _Collector(2)
    engine.submit_stream(prompt, col.sink(0), max_new_tokens=4)
    engine.drain()
    engine.swap_params(other)
    engine.submit_stream(prompt, col.sink(1), max_new_tokens=4)
    engine.drain()
    assert engine.swaps_total == 1
    assert col.final(0)["tokens"] == _port_generate(tcfg, tparams, prompt, 4)
    assert col.final(1)["tokens"] == _port_generate(tcfg, other, prompt, 4)
    assert col.final(1)["cache_hit"] is False


def test_scheduler_survives_a_failed_cycle_and_counts_it():
    """A cycle that raises is logged and counted; the loop goes on, and a
    later good cycle resets only the consecutive count."""
    cycles = []
    recovered = threading.Event()

    class Flaky:
        def step_cycle(self):
            cycles.append(None)
            if len(cycles) == 1:
                raise RuntimeError("poisoned request")
            recovered.set()
            return False

        def wait_for_work(self, timeout):
            recovered.wait(timeout)

    sched = Scheduler(Flaky(), idle_wait_s=0.001).start()
    try:
        assert recovered.wait(10)
    finally:
        sched.stop()
    assert sched.failures_total == 1
    assert sched.consecutive_failures == 0


# ------------------------------------------------------ the device rule


@pytest.mark.parametrize("entry", ["make_engine", "ContinuousBatcher",
                                   "generate", "forward_with_cache",
                                   "params_from_jax", "KVCache.init"])
def test_entry_points_need_a_card_unless_the_cpu_is_asked_for(
        entry, monkeypatch):
    from kubeflow_tpu_torch.models import decoding as tdec

    jcfg, tcfg, jparams, tparams = _setup()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cache = tdec.KVCache.init(tcfg, 1, 8, device="cpu")
    calls = {
        "make_engine": lambda **kw: make_engine(tcfg, tparams, max_batch=1,
                                                max_len=32, **kw),
        "ContinuousBatcher": lambda **kw: ContinuousBatcher(
            tcfg, tparams, max_batch=1, max_len=32, **kw),
        "generate": lambda **kw: generate(tcfg, tparams, [[1, 2]], 2, **kw),
        "forward_with_cache": lambda **kw: tdec.forward_with_cache(
            tcfg, tparams, [[1, 2]], cache, **kw),
        "params_from_jax": lambda **kw: params_from_jax(
            tcfg, jax.tree.map(np.asarray, jparams), **kw),
        "KVCache.init": lambda **kw: tdec.KVCache.init(tcfg, 1, 8, **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    calls[entry](device="cpu")  # the CPU, when asked for, serves

"""CPU parity of the port's LM (models/transformer, convert, decoding)
against the JAX package, at tiny sizes.

The flax params are initialised by the JAX package, carried across as
numpy arrays (``jax.tree.map(np.asarray, params)``) into
``params_from_jax``, and both sides run in f32 on the CPU. Logits agree
to ``ATOL`` = 1e-4 absolute (values of order 1-10 after two layers, f32
sums in a different order); caches to 1e-5; greedy tokens exactly.
int8 caches allow 2e-3 on logits: a quantised row can land one int8
step apart when the two sides' f32 values straddle a rounding boundary.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import decoding as jdec
from kubeflow_tpu.models import LMConfig as JConfig
from kubeflow_tpu.models import build_lm, create_lm_state
from kubeflow_tpu_torch.models import decoding as tdec
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.transformer import LMConfig, TransformerLM

ATOL = 1e-4
ATOL_INT8 = 2e-3
SMALL = dict(vocab=128, layers=2, dim=64, heads=4, kv_heads=2)


def _configs(**kw):
    fields = {**SMALL, **kw}
    return (JConfig(dtype=jnp.float32, **fields),
            LMConfig(dtype=torch.float32, **fields))


def _params(jcfg, tcfg, seed=0):
    model = build_lm(jcfg, use_flash=False)
    state = create_lm_state(model, jax.random.key(seed), (1, 16))
    jparams = state.params
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return model, jparams, tparams


def _tokens(rng, vocab, b, t):
    return rng.integers(0, vocab, (b, t)).astype(np.int32)


@pytest.mark.parametrize("window", [None, 6], ids=["causal", "window"])
def test_converter_and_forward_match_flax(window):
    jcfg, tcfg = _configs(attn_window=window)
    model, jparams, tparams = _params(jcfg, tcfg)
    tokens = _tokens(np.random.default_rng(0), jcfg.vocab, 2, 12)
    ref = model.apply({"params": jparams}, jnp.asarray(tokens))
    out = TransformerLM(tcfg)(tparams, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_converter_keeps_names_layouts_and_casts_once():
    jcfg, tcfg = _configs()
    tcfg_bf16 = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    _, jparams, _ = _params(jcfg, tcfg)
    tp = params_from_jax(tcfg_bf16, jax.tree.map(np.asarray, jparams),
                         device="cpu")
    blk = tp["block_0"]
    assert set(blk) == {"RMSNorm_0", "RMSNorm_1", "q_proj", "k_proj",
                        "v_proj", "proj", "up", "down"}
    assert tuple(blk["k_proj"]["kernel"].shape) == (64, 32)  # (in, out)
    assert tuple(tp["embed"]["embedding"].shape) == (128, 64)
    assert blk["up"]["kernel"].dtype == torch.bfloat16
    assert blk["RMSNorm_0"]["scale"].dtype == torch.float32
    assert tp["final_norm"]["scale"].dtype == torch.float32
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(dataclasses.replace(tcfg, layers=3),
                        jax.tree.map(np.asarray, jparams), device="cpu")


def _jcache_np(cache):
    return np.asarray(cache.k), np.asarray(cache.v)


@pytest.mark.parametrize("variant", ["linear", "int8", "rolling",
                                     "rolling_int8"])
def test_forward_with_cache_matches_jax(variant):
    """Empty prefill, then (linear only) a mid-sequence chunk, then two
    single-token steps; logits and the cache contents agree."""
    rolling = variant.startswith("rolling")
    quantized = variant.endswith("int8")
    jcfg, tcfg = _configs(attn_window=8 if rolling else None)
    _, jparams, tparams = _params(jcfg, tcfg, seed=1)
    rng = np.random.default_rng(1)
    chunks = [_tokens(rng, jcfg.vocab, 2, 12)]
    if not rolling:
        chunks.append(_tokens(rng, jcfg.vocab, 2, 5))
    chunks += [_tokens(rng, jcfg.vocab, 2, 1) for _ in range(2)]
    max_len = 40
    jc = jdec.KVCache.init(jcfg, 2, max_len, rolling=rolling,
                           quantized=quantized)
    tc = tdec.KVCache.init(tcfg, 2, max_len, rolling=rolling,
                           quantized=quantized, device="cpu")
    atol = ATOL_INT8 if quantized else ATOL
    for chunk in chunks:
        jl, jc = jdec.forward_with_cache(jcfg, jparams, jnp.asarray(chunk),
                                         jc)
        tl, tc = tdec.forward_with_cache(tcfg, tparams,
                                         torch.from_numpy(chunk), tc,
                                         device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol,
                                   rtol=0)
        assert tc.length == int(jc.length)
    jk, jv = _jcache_np(jc)
    if quantized:
        np.testing.assert_allclose(tc.k_scale.numpy(),
                                   np.asarray(jc.k_scale), atol=1e-6)
        assert np.mean(tc.k.numpy() != jk) < 1e-3
    else:
        np.testing.assert_allclose(tc.k.numpy(), jk, atol=1e-5)
        np.testing.assert_allclose(tc.v.numpy(), jv, atol=1e-5)


def test_prefill_last_logits_only_and_overflow():
    jcfg, tcfg = _configs()
    _, _, tparams = _params(jcfg, tcfg)
    tokens = torch.arange(10).reshape(1, 10)
    cache = tdec.KVCache.init(tcfg, 1, 16, device="cpu")
    full, _ = tdec.forward_with_cache(tcfg, tparams, tokens, cache,
                                      device="cpu")
    cache = tdec.KVCache.init(tcfg, 1, 16, device="cpu")
    last, cache = tdec.forward_with_cache(tcfg, tparams, tokens, cache,
                                          last_logits_only=True,
                                          device="cpu")
    assert tuple(last.shape) == (1, 1, 128)
    torch.testing.assert_close(last[:, 0], full[:, -1])
    with pytest.raises(ValueError, match="overflow"):
        tdec.forward_with_cache(tcfg, tparams, torch.zeros(1, 7).long(),
                                cache, device="cpu")


@pytest.mark.parametrize("variant", ["plain", "window_rolling", "int8"])
def test_generate_greedy_matches_jax(variant):
    jcfg, tcfg = _configs(attn_window=6 if variant == "window_rolling"
                          else None)
    _, jparams, tparams = _params(jcfg, tcfg, seed=2)
    prompt = _tokens(np.random.default_rng(2), jcfg.vocab, 2, 9)
    quantized = variant == "int8"
    ref = jdec.generate(jcfg, jparams, jnp.asarray(prompt), 10,
                        quantize_cache=quantized)
    out = tdec.generate(tcfg, tparams, prompt, 10, quantize_cache=quantized,
                        device="cpu")
    assert out.dtype == torch.int32
    assert out.tolist() == np.asarray(ref).tolist()


def test_forced_kernel_path_matches_jax_kernels(monkeypatch):
    """Both sides forced onto their kernels (Pallas interpret mode; the
    port's wrappers on CPU tensors run their plain twins): the decode
    step's fused QKV+RoPE, GEMV projections with residual epilogues and
    the tied head (and, on the port's side, flash-decode; the reference
    keeps its dense read off-TPU) give the same greedy tokens."""
    jcfg, tcfg = _configs(vocab=256, dim=128)
    _, jparams, tparams = _params(jcfg, tcfg, seed=3)
    for mod in (jdec, tdec):
        monkeypatch.setattr(mod, "DECODE_MM", "gemv")
        monkeypatch.setattr(mod, "DECODE_FUSED", "on")
        monkeypatch.setattr(mod, "DECODE_IMPL", "kernel")
    monkeypatch.setattr(jdec, "DECODE_KERNEL_MIN", 0)
    prompt = _tokens(np.random.default_rng(3), jcfg.vocab, 1, 8)
    jax.clear_caches()
    ref = jdec.generate(jcfg, jparams, jnp.asarray(prompt), 6)
    jax.clear_caches()
    out = tdec.generate(tcfg, tparams, prompt, 6, device="cpu")
    assert out.tolist() == np.asarray(ref).tolist()


def test_dispatch_rule_on_the_cpu_and_forced():
    """"auto" takes no kernel for CPU tensors; forcing runs the twin."""
    _, tcfg = _configs()
    q = torch.zeros(1, 4, 1, 16)
    assert not tdec.attention_kernel_wanted(tcfg, 256, False, False, q)
    assert not tdec._fused_step_wanted(q)
    h = torch.zeros(1, 1, 64)
    out = tdec._mm(h, torch.ones(64, 32), torch.float32,
                   residual=torch.ones(1, 1, 32))
    assert out.dtype == torch.float32 and float(out.sum()) == 32.0


def test_selectors_validate(monkeypatch):
    """The KFT_DECODE_* selectors (read once at import through these
    helpers) refuse a typo or a negative threshold."""
    monkeypatch.setenv("KFT_DECODE_MM", "gemmv")
    with pytest.raises(ValueError, match="KFT_DECODE_MM"):
        tdec._choice("KFT_DECODE_MM", "auto", ("auto", "dense", "gemv"))
    monkeypatch.setenv("KFT_DECODE_KERNEL_MIN", "-1")
    with pytest.raises(ValueError, match="KFT_DECODE_KERNEL_MIN"):
        tdec._count("KFT_DECODE_KERNEL_MIN", 0)
    monkeypatch.setenv("KFT_DECODE_KERNEL_MIN", "4096")
    assert tdec._count("KFT_DECODE_KERNEL_MIN", 0) == 4096
    assert tdec.DECODE_KERNEL_MIN == 0 and tdec.DECODE_MM == "auto"


def test_rolling_mid_sequence_chunk_is_a_later_slice():
    """A multi-token chunk on a filled ring was refused until the rolling
    chunk path was ported; it now runs, and the ring holds the chunk's
    keys at their slots (position p at p % capacity)."""
    _, tcfg = _configs(attn_window=4)
    jcfg, _ = _configs(attn_window=4)
    _, _, tparams = _params(jcfg, tcfg)
    cache = tdec.KVCache.init(tcfg, 1, 16, rolling=True, device="cpu")
    _, cache = tdec.forward_with_cache(tcfg, tparams,
                                       torch.zeros(1, 3).long(), cache,
                                       device="cpu")
    before = cache.k.clone()
    logits, cache = tdec.forward_with_cache(tcfg, tparams,
                                            torch.ones(1, 2).long(), cache,
                                            device="cpu")
    assert tuple(logits.shape) == (1, 2, tcfg.vocab) and cache.length == 5
    # Positions 3 and 4 land in slots 3 and 0; slots 1 and 2 keep 1, 2.
    assert not torch.equal(cache.k[:, :, :, 3], before[:, :, :, 3])
    assert not torch.equal(cache.k[:, :, :, 0], before[:, :, :, 0])
    assert torch.equal(cache.k[:, :, :, 1:3], before[:, :, :, 1:3])


@pytest.mark.parametrize("size", [1, 3, 7])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf", "int8"])
def test_rolling_chunks_match_jax_and_the_full_forward(size, quantized):
    """A ring of capacity 5 fed in chunks of ``size`` (7 crosses the
    ring's end inside one chunk and keeps only its last 5 positions):
    at every chunk the logits and the ring's contents equal the
    reference's, and on the float ring the logits equal the full
    windowed forward at the same positions (the reference's decode
    contract; an int8 ring carries its quantisation error, which the
    reference's side carries too)."""
    jcfg, tcfg = _configs(attn_window=5)
    model, jparams, tparams = _params(jcfg, tcfg, seed=4)
    tokens = _tokens(np.random.default_rng(4), jcfg.vocab, 2, 22)
    full = TransformerLM(tcfg)(tparams, torch.from_numpy(tokens).long())
    jc = jdec.KVCache.init(jcfg, 2, 22, rolling=True, quantized=quantized)
    tc = tdec.KVCache.init(tcfg, 2, 22, rolling=True, quantized=quantized,
                           device="cpu")
    atol = ATOL_INT8 if quantized else ATOL
    for start in range(0, 22, size):
        chunk = tokens[:, start:start + size]
        jl, jc = jdec.forward_with_cache(jcfg, jparams, jnp.asarray(chunk),
                                         jc)
        tl, tc = tdec.forward_with_cache(tcfg, tparams,
                                         torch.from_numpy(chunk), tc,
                                         device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol,
                                   rtol=0, err_msg=f"chunk at {start}")
        if not quantized:
            np.testing.assert_allclose(
                tl.numpy(), full[:, start:start + size].detach().numpy(),
                atol=atol, rtol=0, err_msg=f"full forward at {start}")
        assert tc.length == int(jc.length)
        jk, jv = _jcache_np(jc)
        if quantized:
            np.testing.assert_allclose(tc.k_scale.numpy(),
                                       np.asarray(jc.k_scale), atol=1e-6)
            np.testing.assert_allclose(tc.v_scale.numpy(),
                                       np.asarray(jc.v_scale), atol=1e-6)
            # One int8 step where both sides' f32 straddle a boundary.
            assert np.abs(tc.k.numpy().astype(int) - jk.astype(int)).max() <= 1
            assert np.mean(tc.k.numpy() != jk) < 1e-2
        else:
            np.testing.assert_allclose(tc.k.numpy(), jk, atol=1e-5)
            np.testing.assert_allclose(tc.v.numpy(), jv, atol=1e-5)


def test_write_rolling_chunk_splits_at_the_ring_end():
    """Position p lands in slot p % capacity, the last ``capacity``
    positions only, for every offset and length around the wrap."""
    capacity = 5
    for pos in range(0, 12):
        for t in range(1, 13):
            buf = torch.full((1, 1, capacity, 1), -1.0)
            chunk = torch.arange(pos, pos + t, dtype=torch.float32)
            tdec._write_rolling_chunk(buf, chunk.reshape(1, 1, t, 1), pos,
                                      capacity)
            want = torch.full((capacity,), -1.0)
            for p in range(max(pos, pos + t - capacity), pos + t):
                want[p % capacity] = p
            assert torch.equal(buf.reshape(-1), want), (pos, t)


STACKED_VARIANTS = {"linear": {}, "rolling": {"attn_window": 5},
                    "int8_cache": {}}


@pytest.mark.parametrize("variant", sorted(STACKED_VARIANTS))
def test_stacked_params_match_per_layer_and_jax(variant):
    """forward_with_cache on ``stack_decode_params`` gives the per-layer
    form's numbers exactly (one block code, views of the stacked
    tensors) and the reference's stacked form's within ATOL, for a
    prefill, a chunk and single-token steps."""
    jcfg, tcfg = _configs(**STACKED_VARIANTS[variant])
    _, jparams, tparams = _params(jcfg, tcfg, seed=5)
    rolling = variant == "rolling"
    quantized = variant == "int8_cache"
    jsp = jdec.stack_decode_params(jcfg, jparams)
    tsp = tdec.stack_decode_params(tcfg, tparams)
    assert tuple(tsp.qkv.shape) == tuple(jsp.qkv.shape) == (2, 64, 128)
    tokens = _tokens(np.random.default_rng(5), jcfg.vocab, 2, 16)
    kw = dict(rolling=rolling, quantized=quantized)
    jc = jdec.KVCache.init(jcfg, 2, 16, **kw)
    layer = tdec.KVCache.init(tcfg, 2, 16, device="cpu", **kw)
    stacked = tdec.KVCache.init(tcfg, 2, 16, device="cpu", **kw)
    for a, b in [(0, 8), (8, 11), (11, 12), (12, 13), (13, 14)]:
        chunk = tokens[:, a:b]
        jl, jc = jdec.forward_with_cache(jcfg, jsp, jnp.asarray(chunk), jc)
        ll, layer = tdec.forward_with_cache(tcfg, tparams,
                                            torch.from_numpy(chunk), layer,
                                            device="cpu")
        sl, stacked = tdec.forward_with_cache(tcfg, tsp,
                                              torch.from_numpy(chunk),
                                              stacked, device="cpu")
        assert torch.equal(sl, ll), (a, b)
        np.testing.assert_allclose(sl.numpy(), np.asarray(jl),
                                   atol=ATOL_INT8 if quantized else ATOL,
                                   rtol=0)
    assert torch.equal(stacked.k, layer.k) and torch.equal(stacked.v,
                                                           layer.v)
    assert stacked.length == layer.length == int(jc.length)


@pytest.mark.parametrize("window", [None, 6], ids=["causal", "rolling"])
def test_generate_on_stacked_params_matches_per_layer_and_jax(window):
    jcfg, tcfg = _configs(attn_window=window)
    _, jparams, tparams = _params(jcfg, tcfg, seed=6)
    prompt = _tokens(np.random.default_rng(6), jcfg.vocab, 2, 9)
    ref = jdec.generate(jcfg, jdec.stack_decode_params(jcfg, jparams),
                        jnp.asarray(prompt), 8)
    out = tdec.generate(tcfg, tdec.stack_decode_params(tcfg, tparams),
                        prompt, 8, device="cpu")
    per_layer = tdec.generate(tcfg, tparams, prompt, 8, device="cpu")
    assert out.tolist() == per_layer.tolist() == np.asarray(ref).tolist()


def test_stacked_params_refusals():
    """The reference's refusals: MoE layers, int8 params, and
    ``quantize_weights`` on stacked params."""
    _, tcfg = _configs()
    jcfg, _ = _configs()
    _, _, tparams = _params(jcfg, tcfg)
    with pytest.raises(ValueError, match="uniform"):
        tdec.stack_decode_params(dataclasses.replace(tcfg, moe_experts=2),
                                 tparams)
    with pytest.raises(ValueError, match="unrolled path"):
        tdec.stack_decode_params(tcfg,
                                 tdec.quantize_decode_params(tcfg, tparams))
    sp = tdec.stack_decode_params(tcfg, tparams)
    with pytest.raises(ValueError, match="raw training"):
        tdec.generate(tcfg, sp, [[1, 2]], 2, quantize_weights=True,
                      device="cpu")

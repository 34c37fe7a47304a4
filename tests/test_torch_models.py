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


# The LM's products on the CPU and the card's tensor-core path run on CPU
# tensors (``models/transformer.py``: ``_dense``, ``tied_head``,
# ``_DenseMM``, ``_TiedHead``; ``ops/split.py``).

def _spread_f32(shape, lo_exp, hi_exp, seed):
    """f32 values of magnitude 2^lo_exp to 2^hi_exp, both signs, every
    fifth one zero (a negative zero among them)."""
    gen = torch.Generator().manual_seed(seed)
    exp = torch.randint(lo_exp, hi_exp, shape, generator=gen).float()
    mant = 1.0 + torch.rand(shape, generator=gen)
    sign = torch.randint(0, 2, shape, generator=gen).float() * 2 - 1
    g = sign * mant * torch.pow(2.0, exp)
    g.view(-1)[::5] = 0.0
    g.view(-1)[1] = -0.0
    return g


@pytest.mark.parametrize("lo_exp,hi_exp", [(-100, -60), (-60, 0), (0, 100),
                                           (-100, 100)],
                         ids=["tiny", "small", "large", "all"])
def test_split3_reconstructs_f32_values_bit_exactly(lo_exp, hi_exp):
    """hi + mid + lo gives back every f32 value of magnitude 2^-100 to
    2^100, and each term is the bf16 rounding of what the terms before it
    left; the CPU call is the twin and counts no launch."""
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops.split import split3, split3_reference

    g = _spread_f32((33, 130), lo_exp, hi_exp, seed=lo_exp + 1000)
    before = dict(_build.LAUNCHES)
    parts = split3(g)
    assert _build.LAUNCHES == before
    assert parts.dtype == torch.bfloat16 and parts.shape == (33, 390)
    assert torch.equal(parts, split3_reference(g))
    hi, mid, lo = parts[:, :130], parts[:, 130:260], parts[:, 260:]
    assert torch.equal(hi, g.to(torch.bfloat16))
    assert torch.equal(mid, (g - hi.float()).to(torch.bfloat16))
    assert torch.equal((hi.double() + mid.double() + lo.double()).float(), g)


def test_split3_refuses_what_it_does_not_take():
    from kubeflow_tpu_torch.ops.split import split3

    with pytest.raises(ValueError):
        split3(torch.zeros(4, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        split3(torch.zeros(2, 3, 4))


def _widened_dense(h, w, dtype):
    return (h.to(dtype).float() @ w.to(dtype).float()).to(dtype)


def _widened_head(x, emb, dtype):
    return torch.einsum("bsd,vd->bsv", x.to(dtype).float(),
                        emb.to(dtype).float())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("which", ["dense", "head"])
def test_dense_and_tied_head_on_the_cpu_keep_the_widened_expression(
        which, dtype):
    """On CPU tensors ``_dense`` and ``tied_head`` are the widened f32
    expressions, bit for bit, gradients included, and count no
    tensor-core product."""
    from kubeflow_tpu_torch.models.transformer import (
        TENSOR_CORE_PRODUCTS,
        _dense,
        tied_head,
    )
    from kubeflow_tpu_torch.ops import _build

    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 9, 48, generator=gen).to(dtype).requires_grad_()
    if which == "dense":
        w = (torch.randn(48, 80, generator=gen) * 0.1).requires_grad_()
        fn, twin = _dense, _widened_dense
    else:
        w = (torch.randn(101, 48, generator=gen) * 0.1).requires_grad_()
        fn, twin = tied_head, _widened_head
    before = dict(_build.LAUNCHES), dict(TENSOR_CORE_PRODUCTS)
    out = fn(x, w, dtype)
    assert (_build.LAUNCHES, TENSOR_CORE_PRODUCTS) == before
    ref = twin(x, w, dtype)
    assert out.dtype == ref.dtype and torch.equal(out, ref)
    g = torch.randn(out.shape, generator=gen).to(out.dtype)
    for a, b in zip(torch.autograd.grad(out, (x, w), g),
                    torch.autograd.grad(ref, (x, w), g)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _within_one_bf16_ulp(out, ref):
    """Each element within one bf16 ulp of the larger of its magnitude
    and 2^-6 of its row's RMS (f32 sums in another order)."""
    r = ref.float()
    rms = r.pow(2).mean(-1, keepdim=True).sqrt()
    _, exp = torch.frexp(torch.maximum(r.abs(), 2.0 ** -6 * rms))
    ulp = torch.ldexp(torch.ones_like(r), exp - 8)
    return bool(((out.float() - r).abs() <= ulp).all())


@pytest.mark.parametrize("rows,fan_in,fan_out", [(18, 48, 80), (64, 96, 32)])
def test_dense_tensor_core_function_matches_the_widened_product(
        rows, fan_in, fan_out):
    """The card's ``_DenseMM`` run on CPU tensors (its products widened
    there): the output, dh and dw in the dtypes the widened expression's
    autograd gives, each within one bf16 ulp of it."""
    from kubeflow_tpu_torch.models.transformer import _DenseMM

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(rows)
    h = torch.randn(rows, fan_in, generator=gen).to(bf16).requires_grad_()
    w = (torch.randn(fan_in, fan_out, generator=gen)
         * fan_in ** -0.5).requires_grad_()
    out = _DenseMM.apply(h, w.to(bf16))
    ref = _widened_dense(h, w, bf16)
    g = (torch.randn(out.shape, generator=gen) * 1e-3).to(bf16)
    got = torch.autograd.grad(out, (h, w), g)
    want = torch.autograd.grad(ref, (h, w), g)
    assert out.dtype == bf16 and _within_one_bf16_ulp(out, ref)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, a.to(bf16).float().to(a.dtype))
        assert _within_one_bf16_ulp(a, b)


@pytest.mark.parametrize("rows,dim,vocab", [(18, 48, 101), (64, 32, 256)])
def test_tied_head_tensor_core_function_matches_the_widened_product(
        rows, dim, vocab):
    """The card's ``_TiedHead`` run on CPU tensors: f32 logits to 1e-6
    relative; dx (bf16) and the embedding's gradient (rounded to bf16,
    widened to f32) within one bf16 ulp of the widened expression's,
    from a softmax-like f32 logit gradient that bf16 alone would round."""
    from kubeflow_tpu_torch.models.transformer import _TiedHead

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(vocab)
    x = torch.randn(1, rows, dim, generator=gen).to(bf16).requires_grad_()
    emb = (torch.randn(vocab, dim, generator=gen) * 0.05).requires_grad_()
    out = _TiedHead.apply(x.reshape(rows, dim),
                          emb.to(bf16)).reshape(1, rows, vocab)
    ref = _widened_head(x, emb, bf16)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    g = torch.rand(1, rows, vocab, generator=gen) / (rows * vocab)
    g[0, torch.arange(rows), torch.randint(0, vocab, (rows,),
                                           generator=gen)] = -1.0 / rows
    assert not torch.equal(g.to(bf16).float(), g)
    got = torch.autograd.grad(out, (x, emb), g)
    want = torch.autograd.grad(ref, (x, emb), g)
    assert got[0].dtype == bf16 and got[1].dtype == torch.float32
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert _within_one_bf16_ulp(a.reshape(-1, a.shape[-1]),
                                    b.reshape(-1, b.shape[-1]))
    assert torch.equal(got[1], got[1].to(bf16).float())


@pytest.mark.parametrize("k,transposed", [(9000, False), (8192, True),
                                          (4100, True), (100, False)],
                         ids=["rest", "whole_view", "one_chunk", "short"])
def test_chunked_f32_product_matches_the_widened_product(k, transposed):
    """``_mm_f32_chunked`` (the tied head's backward products): sums cut
    at ``HEAD_SUM_CHUNK`` terms, a remainder added after, a transposed
    operand (the embedding gradient's) read as a view; f32 results equal
    to the widened product up to the order of the sums."""
    from kubeflow_tpu_torch.models.transformer import _mm_f32_chunked

    gen = torch.Generator().manual_seed(k)
    a = torch.randn(24, k, generator=gen).to(torch.bfloat16)
    if transposed:
        a = torch.randn(k, 24, generator=gen).to(torch.bfloat16).t()
    b = torch.randn(k, 40, generator=gen).to(torch.bfloat16)
    out = _mm_f32_chunked(a, b)
    assert out.dtype == torch.float32 and out.shape == (24, 40)
    torch.testing.assert_close(out, a.double() @ b.double(),
                               rtol=1e-5, atol=1e-4, check_dtype=False)

"""CPU parity of the port's weight-only int8 decode (W8A16) against the
JAX package, at tiny sizes.

``quantize_decode_params`` must give the reference's int8 payload bit
for bit and its scales to 1e-7 relative (both divide the same f32 absmax
by 127 and round half to even). Decoding through int8 weights then runs
the same f32 arithmetic on both sides, so first-step logits agree to
``ATOL`` = 1e-4 absolute (f32 sums in another order, as in
``test_torch_models.py``) and greedy tokens exactly. The batcher and the
streaming engine on quantised params must equal the port's own
``generate(quantize_weights=True)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import LMConfig as JConfig
from kubeflow_tpu.models import build_lm, create_lm_state
from kubeflow_tpu.models import decoding as jdec
from kubeflow_tpu_torch.models import decoding as tdec
from kubeflow_tpu_torch.models.convert import params_from_jax
from kubeflow_tpu_torch.models.serving import ContinuousBatcher
from kubeflow_tpu_torch.models.transformer import LMConfig
from kubeflow_tpu_torch.serving import make_engine

ATOL = 1e-4
SCALE_RTOL = 1e-7
SMALL = dict(vocab=128, layers=2, dim=64, heads=4, kv_heads=2)
PROJECTIONS = ("q_proj", "k_proj", "v_proj", "proj", "up", "down")


def _setup(seed=0, **kw):
    fields = {**SMALL, **kw}
    jcfg = JConfig(dtype=jnp.float32, **fields)
    tcfg = LMConfig(dtype=torch.float32, **fields)
    model = build_lm(jcfg, use_flash=False)
    jparams = create_lm_state(model, jax.random.key(seed), (1, 16)).params
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompt(seed, n, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(
        np.int32)


def _pairs(jq, tq):
    """(name, JAX Int8Linear, port Int8Linear) for every quantised leaf."""
    yield "embed", jq["embed"]["embedding"], tq["embed"]["embedding"]
    for key in sorted(k for k in tq if k.startswith("block_")):
        for name in PROJECTIONS:
            yield (f"{key}/{name}", jq[key][name]["kernel"],
                   tq[key][name]["kernel"])


def test_quantize_decode_params_matches_reference():
    jcfg, tcfg, jparams, tparams = _setup()
    jq = jdec.quantize_decode_params(jcfg, jparams)
    fused = tdec.fuse_qkv_params(tcfg, tparams)
    fused["block_0"] = {**fused["block_0"],
                        tdec.FUSED_QKV_KEY: {"w": None, "scale": None}}
    tq = tdec.quantize_decode_params(tcfg, fused)
    assert tdec.FUSED_QKV_KEY not in tq["block_0"]
    count = 0
    for name, jl, tl in _pairs(jq, tq):
        assert isinstance(tl, tdec.Int8Linear), name
        assert tl.w8.dtype == torch.int8 and tl.scale.dtype == torch.float32
        np.testing.assert_array_equal(tl.w8.numpy(), np.asarray(jl.w8),
                                      err_msg=name)
        np.testing.assert_allclose(tl.scale.numpy(), np.asarray(jl.scale),
                                   rtol=SCALE_RTOL, atol=0, err_msg=name)
        count += 1
    assert count == 1 + SMALL["layers"] * len(PROJECTIONS)
    # Norms pass through untouched, f32.
    assert tq["final_norm"]["scale"] is tparams["final_norm"]["scale"]
    assert tq["block_1"]["RMSNorm_0"] is tparams["block_1"]["RMSNorm_0"]
    # The embedding quantises per vocab row (axis 1), projections per
    # output column (axis 0).
    assert tuple(tq["embed"]["embedding"].scale.shape) == (SMALL["vocab"],)
    assert tuple(tq["block_0"]["up"]["kernel"].scale.shape) == (
        4 * SMALL["dim"],)


def test_quantize_linear_floors_and_clips_like_the_reference():
    w = np.array([[0.0, 1.0, -3.0], [0.0, -0.5, 2.999], [0.0, 0.25, 1.5]],
                 np.float32)
    jl = jdec._quantize_linear(jnp.asarray(w), axis=0)
    tl = tdec._quantize_linear(torch.from_numpy(w), axis=0)
    np.testing.assert_array_equal(tl.w8.numpy(), np.asarray(jl.w8))
    np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
    assert float(tl.scale[0]) == pytest.approx(1e-12 / 127.0)
    assert tl.w8.abs().max() == 127


@pytest.mark.parametrize("quantize_cache", [False, True],
                         ids=["bf16_cache", "int8_cache"])
def test_generate_quantize_weights_matches_jax(quantize_cache):
    jcfg, tcfg, jparams, tparams = _setup(seed=1)
    prompt = _prompt(1, 9)
    ref = jdec.generate(jcfg, jparams, jnp.asarray(prompt), 8,
                        quantize_weights=True, quantize_cache=quantize_cache)
    out = tdec.generate(tcfg, tparams, prompt, 8, quantize_weights=True,
                        quantize_cache=quantize_cache, device="cpu")
    assert out.tolist() == np.asarray(ref).tolist()


def test_int8_logits_match_jax_at_prefill_and_first_step():
    jcfg, tcfg, jparams, tparams = _setup(seed=2)
    jq = jdec.quantize_decode_params(jcfg, jparams)
    tq = tdec.quantize_decode_params(tcfg, tparams)
    prompt = _prompt(2, 7)
    jcache = jdec.KVCache.init(jcfg, 1, 16)
    jl1, jcache = jdec.forward_with_cache(jcfg, jq, jnp.asarray(prompt),
                                          jcache)
    nxt = np.asarray(jnp.argmax(jl1[:, -1], -1))[:, None].astype(np.int32)
    jl2, _ = jdec.forward_with_cache(jcfg, jq, jnp.asarray(nxt), jcache)
    tcache = tdec.KVCache.init(tcfg, 1, 16, device="cpu")
    tl1, tcache = tdec.forward_with_cache(tcfg, tq, prompt, tcache,
                                          device="cpu")
    tl2, _ = tdec.forward_with_cache(tcfg, tq, nxt, tcache, device="cpu")
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL,
                               rtol=0)
    # int8 moves the logits off the float model's: the check above is
    # not vacuous.
    tf1, _ = tdec.forward_with_cache(
        tcfg, tparams, prompt, tdec.KVCache.init(tcfg, 1, 16, device="cpu"),
        device="cpu")
    assert float((tf1 - tl1).abs().max()) > 10 * ATOL


def test_generate_refuses_already_quantised_params():
    _, tcfg, _, tparams = _setup()
    tq = tdec.quantize_decode_params(tcfg, tparams)
    with pytest.raises(ValueError, match="already quantised"):
        tdec.generate(tcfg, tq, [[1, 2, 3]], 2, quantize_weights=True,
                      device="cpu")
    # Quantised params passed directly decode as quantize_weights does.
    direct = tdec.generate(tcfg, tq, [[1, 2, 3]], 4, device="cpu")
    again = tdec.generate(tcfg, tparams, [[1, 2, 3]], 4,
                          quantize_weights=True, device="cpu")
    assert direct.tolist() == again.tolist()


def test_batcher_and_engine_on_quantised_params_equal_generate():
    _, tcfg, _, tparams = _setup(seed=3)
    tq = tdec.quantize_decode_params(tcfg, tparams)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, 128, n)] for n in (5, 9, 3)]
    prompts.append(prompts[1] + [7, 8])   # extends a cached prompt

    def reference(prompt, n, temp=0.0, seed=None):
        return tdec.generate(tcfg, tparams, [prompt], n, temperature=temp,
                             rng=seed, quantize_weights=True,
                             device="cpu")[0].tolist()

    batcher = ContinuousBatcher(tcfg, tq, max_batch=2, max_len=64,
                                step_chunk=3, device="cpu")
    ids = [batcher.submit(p, max_new_tokens=6) for p in prompts]
    results = batcher.run()
    for rid, prompt in zip(ids, prompts):
        assert results[rid] == reference(prompt, 6)

    engine = make_engine(tcfg, tq, max_batch=2, max_len=64, device="cpu")
    done = {}
    temps = [0.0, 0.9, 0.0, 0.0]
    seeds = [None, 5, None, None]
    for i, prompt in enumerate(prompts):
        engine.submit_stream(
            prompt, lambda e, i=i: done.__setitem__(i, e)
            if e.get("done") else None, max_new_tokens=5,
            temperature=temps[i], rng=seeds[i])
    engine.drain()
    for i, prompt in enumerate(prompts):
        assert done[i]["tokens"] == reference(prompt, 5, temps[i], seeds[i])
    assert done[3]["cache_hit"]


def test_forced_kernel_path_takes_the_int8_twins_and_matches(monkeypatch):
    """Both sides forced onto their kernels (Pallas interpret mode; the
    port's wrappers on CPU tensors run their plain twins) with int8
    weights: the GEMV with and without its residual epilogue, the int8
    fused QKV+RoPE and the int8 tied head give JAX's greedy tokens, and
    the port's int8 twins are what ran."""
    from kubeflow_tpu_torch.ops import decode_qkv, gemv

    jcfg, tcfg, jparams, tparams = _setup(seed=4, vocab=256, dim=128)
    for mod in (jdec, tdec):
        monkeypatch.setattr(mod, "DECODE_MM", "gemv")
        monkeypatch.setattr(mod, "DECODE_FUSED", "on")
    seen = {"gemv": [], "qkv_rope": []}

    def spy(name, fn):
        def wrapped(x, w, *args, **kwargs):
            seen[name].append(w.dtype)
            return fn(x, w, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(tdec, "gemv", spy("gemv", gemv.gemv))
    monkeypatch.setattr(tdec, "qkv_rope", spy("qkv_rope", decode_qkv.qkv_rope))
    prompt = _prompt(4, 8, vocab=256)
    jax.clear_caches()
    ref = jdec.generate(jcfg, jparams, jnp.asarray(prompt), 5,
                        quantize_weights=True)
    jax.clear_caches()
    out = tdec.generate(tcfg, tparams, prompt, 5, quantize_weights=True,
                        device="cpu")
    assert out.tolist() == np.asarray(ref).tolist()
    assert seen["gemv"] and set(seen["gemv"]) == {torch.int8}
    assert seen["qkv_rope"] and set(seen["qkv_rope"]) == {torch.int8}


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("transpose_w", [False, True])
def test_mm_int8_gemv_and_dense_paths_agree(monkeypatch, residual,
                                            transpose_w):
    """``_mm`` on an Int8Linear: the GEMV route (its twin here) and the
    dense route give the same values, in the reference's op order."""
    gen = torch.Generator().manual_seed(5)
    k, n = 64, 48
    w = torch.randn((n, k) if transpose_w else (k, n), generator=gen)
    lin = tdec._quantize_linear(w, axis=1 if transpose_w else 0)
    h = torch.randn(3, 1, k, generator=gen)
    res = torch.randn(3, 1, n, generator=gen) if residual else None
    monkeypatch.setattr(tdec, "DECODE_MM", "dense")
    dense = tdec._mm(h, lin, torch.float32, transpose_w, res)
    monkeypatch.setattr(tdec, "DECODE_MM", "gemv")
    kernel = tdec._mm(h, lin, torch.float32, transpose_w, res)
    wf = lin.w8.float()
    want = h.float() @ (wf.t() if transpose_w else wf) * lin.scale
    if residual:
        want = res + want
    torch.testing.assert_close(dense, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(kernel, want, rtol=1e-6, atol=1e-6)

"""CPU parity of the PyTorch port's kernel modules against the JAX ops.

Inputs come from a seeded numpy generator and go through both the JAX
op (its Pallas kernel in interpret mode, the default off-TPU) and the
port's wrapper on CPU tensors, which runs the kernel's plain PyTorch
twin. Everything compares in f32 with ``ATOL``/``RTOL`` = 1e-5: both
sides do the same f32 arithmetic in a different summation order, so
they agree to a few f32 ulps of values of order one. The CUDA kernels
themselves are held against the same twins on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import attention as jattn
from kubeflow_tpu.ops.decode_attention import decode_attention as j_decode
from kubeflow_tpu.ops.decode_qkv import qkv_rope as j_qkv_rope
from kubeflow_tpu.ops.gemv import gemv as j_gemv
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import (
    NEG_INF,
    apply_rope,
    flash_attention,
    flash_dkv,
    flash_dq,
    flash_forward,
    mha_reference,
)
from kubeflow_tpu_torch.ops.decode_attention import decode_attention
from kubeflow_tpu_torch.ops.decode_qkv import qkv_rope
from kubeflow_tpu_torch.ops.gemv import MAX_ROWS, gemv, gemv_fits

ATOL = RTOL = 1e-5


def _close(port: torch.Tensor, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol)


def _quantize_cols(w: np.ndarray):
    scale = np.maximum(np.abs(w).max(axis=0), 1e-12) / 127.0
    w8 = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return w8, scale.astype(np.float32)


# ---------------------------------------------------------------- gemv


@pytest.mark.parametrize("case", ["plain", "residual", "int8",
                                  "int8_residual", "transpose",
                                  "transpose_int8"])
def test_gemv_matches_jax(case):
    rng = np.random.default_rng(0)
    rows, k, n = 3, 256, 384
    x = rng.standard_normal((rows, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    scale = residual = None
    transpose = case.startswith("transpose")
    if "int8" in case:
        w, scale = _quantize_cols(w)
    if transpose:
        w = np.ascontiguousarray(w.T)
    if "residual" in case:
        residual = rng.standard_normal((rows, n)).astype(np.float32)
    ref = j_gemv(jnp.asarray(x), jnp.asarray(w),
                 scale=None if scale is None else jnp.asarray(scale),
                 residual=None if residual is None else jnp.asarray(residual),
                 transpose_w=transpose)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = gemv(t(x), t(w), t(scale), t(residual), transpose_w=transpose)
    assert out.dtype == torch.float32 and tuple(out.shape) == (rows, n)
    _close(out, ref)


def test_gemv_residual_takes_the_residual_dtype():
    """Residual epilogue order: residual + y.to(residual.dtype), output in
    the residual's dtype (bf16 here)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((2, 32)).astype(np.float32))
    out = gemv(x.bfloat16(), w.bfloat16(), residual=res.bfloat16())
    assert out.dtype == torch.bfloat16
    want = res.bfloat16() + (x.bfloat16().float()
                             @ w.bfloat16().float()).bfloat16()
    assert torch.equal(out, want)


def test_gemv_validation():
    x = torch.zeros(MAX_ROWS + 1, 64)
    with pytest.raises(ValueError, match="thin-row"):
        gemv(x, torch.zeros(64, 32))
    with pytest.raises(ValueError, match="contraction"):
        gemv(torch.zeros(2, 64), torch.zeros(32, 32))
    with pytest.raises(ValueError, match="scale"):
        gemv(torch.zeros(2, 64), torch.zeros(64, 32, dtype=torch.int8),
             residual=torch.zeros(2, 32))
    assert gemv_fits(8, 1024, 32768) and not gemv_fits(9, 1024, 1024)
    assert not gemv_fits(1, 1000, 1024) and not gemv_fits(1, 1024, 1023)
    assert not gemv_fits(1, 1024, 1032)  # 16-byte loads along N


def test_every_flagship_decode_projection_takes_the_gemv(monkeypatch):
    """The flagship's decode-step products (the unfused q/k/v projections,
    proj and down with their residuals, up, the tied head) reach the GEMV
    at every batch the engine runs, none the dense fallback: the kernel's
    fit rule (K and N multiples of 16) holds for every one of them."""
    from kubeflow_tpu_torch.models import decoding as tdec
    from kubeflow_tpu_torch.models.transformer import LMConfig

    cfg = LMConfig(vocab=32768, layers=8, dim=1024, heads=8, kv_heads=2,
                   dtype=torch.bfloat16)
    d, kv = cfg.dim, cfg.num_kv_heads * cfg.head_dim
    hidden = cfg.mlp_ratio * d
    calls = []

    def fake_gemv(x, w, scale=None, residual=None, *, transpose_w=False):
        calls.append((tuple(x.shape), tuple(w.shape), transpose_w))
        n = w.shape[0] if transpose_w else w.shape[1]
        return torch.zeros(x.shape[0], n, dtype=x.dtype)

    def dense(*args):
        raise AssertionError(f"a flagship product took the dense path: "
                             f"{[tuple(a.shape) for a in args[:2]]}")

    monkeypatch.setattr(tdec, "DECODE_MM", "gemv")
    monkeypatch.setattr(tdec, "gemv", fake_gemv)
    monkeypatch.setattr(tdec, "_dense_mm", dense)
    bf16 = torch.bfloat16
    products = [(d, d, False, False), (d, kv, False, False),
                (d, d, False, True), (d, hidden, False, False),
                (hidden, d, False, True), (cfg.vocab, d, True, False)]
    for rows in range(1, MAX_ROWS + 1):
        for w0, w1, transpose, residual in products:
            k = w1 if transpose else w0
            n = w0 if transpose else w1
            h = torch.empty(rows, 1, k, dtype=bf16)
            res = torch.empty(rows, 1, n, dtype=bf16) if residual else None
            tdec._mm(h, torch.empty(w0, w1, dtype=bf16), bf16,
                     transpose_w=transpose, residual=res)
    assert len(calls) == MAX_ROWS * len(products)


# ---------------------------------------------------------------- qkv_rope


@pytest.mark.parametrize("int8", [False, True])
def test_qkv_rope_matches_jax(int8):
    rng = np.random.default_rng(2)
    rows, k, hd, heads, kv_heads = 4, 128, 64, 4, 2
    n = (heads + 2 * kv_heads) * hd
    x = rng.standard_normal((rows, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    scale = None
    if int8:
        w, scale = _quantize_cols(w)
    pos = np.array([0, 5, 17, 300], np.int32)
    ref = j_qkv_rope(jnp.asarray(x), jnp.asarray(w), jnp.asarray(pos),
                     None if scale is None else jnp.asarray(scale),
                     head_dim=hd, rope_heads=heads + kv_heads)
    out = qkv_rope(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(pos),
                   None if scale is None else torch.from_numpy(scale),
                   head_dim=hd, rope_heads=heads + kv_heads)
    _close(out, ref)


def test_qkv_rope_equals_unfused_chain():
    """Fused = projection, round, apply_rope per head, concat with v."""
    rng = np.random.default_rng(3)
    rows, k, hd = 2, 64, 16
    n = 5 * hd
    x = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    pos = torch.tensor([3, 40], dtype=torch.int32)
    out = qkv_rope(x, w, pos, head_dim=hd, rope_heads=3)
    want = []
    for r in range(rows):
        heads = (x[r:r + 1] @ w).reshape(5, 1, hd)  # (heads, seq=1, hd)
        roped = apply_rope(heads[:3], offset=int(pos[r]))
        want.append(torch.cat([roped, heads[3:]]).reshape(-1))
    torch.testing.assert_close(out, torch.stack(want), atol=ATOL, rtol=RTOL)


# ------------------------------------------------------ decode attention


def _cache_inputs(rng, b, h, hkv, cap, hd, int8):
    q = rng.standard_normal((b, h, 1, hd)).astype(np.float32)
    k = rng.standard_normal((b, hkv, cap, hd)).astype(np.float32)
    v = rng.standard_normal((b, hkv, cap, hd)).astype(np.float32)
    ks = vs = None
    if int8:
        ks = (np.abs(k).max(-1, keepdims=True) / 127.0).astype(np.float32)
        vs = (np.abs(v).max(-1, keepdims=True) / 127.0).astype(np.float32)
        k = np.clip(np.round(k / ks), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs), -127, 127).astype(np.int8)
    return q, k, v, ks, vs


@pytest.mark.parametrize("case", [
    # (int8, rolling, window, capacity, positions)
    ("linear", False, False, None, 96, [5, 95, 40]),
    ("ragged_capacity", False, False, None, 100, [99, 0, 63]),
    ("window", False, False, 16, 96, [5, 95, 40]),
    ("int8", True, False, None, 100, [99, 7, 50]),
    ("int8_window", True, False, 24, 96, [90, 3, 30]),
    ("rolling", False, True, 32, 32, [10, 31, 200]),
    ("rolling_int8", True, True, 32, 32, [77, 0, 33]),
    ("scalar_pos", False, False, None, 64, 37),
], ids=lambda c: c[0])
def test_decode_attention_matches_jax(case):
    _, int8, rolling, window, cap, pos = case
    rng = np.random.default_rng(4)
    b, h, hkv, hd = 3, 4, 2, 32
    q, k, v, ks, vs = _cache_inputs(rng, b, h, hkv, cap, hd, int8)
    pos_np = np.asarray(pos, np.int32)
    ref = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(pos_np), window=window, block=32,
                   k_scale=None if ks is None else jnp.asarray(ks),
                   v_scale=None if vs is None else jnp.asarray(vs),
                   rolling=rolling)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    pos_t = pos if isinstance(pos, int) else torch.from_numpy(pos_np)
    out = decode_attention(t(q), t(k), t(v), pos_t, window=window,
                           k_scale=t(ks), v_scale=t(vs), rolling=rolling)
    _close(out, ref)


def test_decode_attention_validation():
    q = torch.zeros(1, 3, 1, 8)
    cache = torch.zeros(1, 2, 16, 8)
    with pytest.raises(ValueError, match="multiple"):
        decode_attention(q, cache, cache, 0)
    with pytest.raises(ValueError, match="pair"):
        decode_attention(torch.zeros(1, 2, 1, 8), cache, cache, 0,
                         k_scale=torch.ones(1, 2, 16, 1))
    with pytest.raises(ValueError, match="window"):
        decode_attention(torch.zeros(1, 2, 1, 8), cache, cache, 0,
                         rolling=True)


# -------------------------------------------------------- flash / mha


def _qkv(rng, b, h, hkv, s, d):
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


@pytest.mark.parametrize("case", [
    ("causal", True, None, False),
    ("window", True, 24, False),
    ("non_causal", False, None, False),
    ("segments", True, None, True),
], ids=lambda c: c[0])
def test_flash_attention_matches_jax(case):
    _, causal, window, segmented = case
    rng = np.random.default_rng(5)
    b, h, hkv, s, d = 2, 4, 2, 64, 32
    q, k, v = _qkv(rng, b, h, hkv, s, d)
    seg = None
    if segmented:
        seg = np.sort(rng.integers(0, 3, (b, s)), axis=1).astype(np.int32)
    ref = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, segment_ids=None if seg is None else jnp.asarray(seg),
        block_q=32, block_k=32)
    out = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    _close(out, ref)


def test_flash_twin_rows_without_live_keys_emit_zero():
    """Sq > Sk under a window: rows from Sk - 1 + window on see no key.
    The forward twin gives them o = 0 and lse = -1e30 (p masked, not left
    to underflow); every other row matches the JAX kernel (interpret
    mode), o and lse. The JAX kernel itself gives the first such row the
    mean of V over the live key block that reaches it, a block-size
    artefact the port does not copy."""
    rng = np.random.default_rng(11)
    b, h, hkv, sq, sk, d, window = 2, 4, 2, 48, 24, 32, 8
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    o, lse = flash_forward(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True, window=window)
    dead = sk - 1 + window
    assert torch.count_nonzero(o[:, :, dead:]) == 0
    assert torch.all(lse[:, :, dead:] == torch.tensor(NEG_INF))
    assert torch.all(lse[:, :, :dead] > -1e3)
    jo, jlse = jattn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, True, window,
        d ** -0.5, 8, 8, True, with_lse=True)
    jo = np.asarray(jo)
    jlse = np.asarray(jlse)[:, 0, :].reshape(b, h, sq)
    _close(o[:, :, :dead], jo[:, :, :dead])
    _close(lse[:, :, :dead], jlse[:, :, :dead])
    assert np.abs(jo[:, :, dead]).max() > 0.1


@pytest.mark.parametrize("kwargs", [
    {"causal": True},
    {"causal": True, "window": 5},
    {"causal": False},
    {"causal": True, "q_offset": 8, "k_offset": 0},
], ids=["causal", "window", "full", "offset"])
def test_mha_reference_matches_jax(kwargs):
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, 1, 4, 1, 16, 8)
    ref = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kwargs)
    out = mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), **kwargs)
    _close(out, ref)


def test_flash_validation():
    q = torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError, match="window requires"):
        flash_attention(q, q, q, window=2)
    with pytest.raises(ValueError, match="non-decreasing"):
        flash_attention(q, q, q, causal=True,
                        segment_ids=torch.tensor([[0, 1, 0, 1, 1, 1, 1, 1]]))


@pytest.mark.parametrize("offset", [0, 7, "per_row"])
def test_apply_rope_matches_jax(offset):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    if offset == "per_row":
        offs = [4, 11]
        ref = np.stack([np.asarray(jattn.apply_rope(jnp.asarray(x[i]),
                                                    offset=o))
                        for i, o in enumerate(offs)])
        out = apply_rope(torch.from_numpy(x),
                         offset=torch.tensor(offs, dtype=torch.int32))
    else:
        ref = jattn.apply_rope(jnp.asarray(x), offset=offset)
        out = apply_rope(torch.from_numpy(x), offset=offset)
    _close(out, ref)


# -------------------------------------------- the card is never faked


@pytest.mark.parametrize("op", ["gemv", "qkv_rope", "decode_attention",
                                "flash_attention", "flash_forward",
                                "flash_attention_grad", "flash_dq",
                                "flash_dkv"])
def test_non_cpu_tensors_never_fall_back_to_the_twin(op):
    """A tensor that is not on the CPU goes to the kernel or raises: the
    plain twin serves CPU tensors only (meta tensors stand in for a
    device this machine does not have)."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    q, kv = torch.empty(1, 2, 8, 32, **meta), torch.empty(1, 1, 8, 32, **meta)
    rows = torch.empty(1, 2, 8, device="meta", dtype=torch.float32)
    calls = {
        "gemv": lambda: gemv(torch.empty(2, 64, **meta),
                             torch.empty(64, 32, **meta)),
        "qkv_rope": lambda: qkv_rope(
            torch.empty(2, 64, **meta), torch.empty(64, 64, **meta),
            torch.zeros(2, dtype=torch.int32, device="meta"),
            head_dim=16, rope_heads=2),
        "decode_attention": lambda: decode_attention(
            torch.empty(1, 2, 1, 32, **meta),
            torch.empty(1, 1, 16, 32, **meta),
            torch.empty(1, 1, 16, 32, **meta), 3),
        "flash_attention": lambda: flash_attention(q, kv, kv, causal=True),
        "flash_forward": lambda: flash_forward(q, kv, kv, causal=True),
        "flash_attention_grad": lambda: flash_attention(
            q.requires_grad_(True), kv, kv, causal=True),
        "flash_dq": lambda: flash_dq(q, kv, kv, q, rows, rows, causal=True),
        "flash_dkv": lambda: flash_dkv(q, kv, kv, q, rows, rows, causal=True),
    }
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[op]()
    assert _build.LAUNCHES == before


def test_build_finds_no_compiler_without_the_toolkit(monkeypatch):
    monkeypatch.delenv("KFT_NVCC", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()

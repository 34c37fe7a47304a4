"""Autoregressive generation with a KV cache for the transformer LM.

The counterpart of ``kubeflow_tpu/models/decoding.py``: pure functions
over the same parameter dict (``q_proj``/``k_proj``/``v_proj``/
``proj``/``up``/``down``/``embed`` are the contract), with decode equal
to the full forward at every prefix.

Where the port differs from the reference, and why:

- PyTorch runs eagerly, so the decode loop is a Python loop (the
  reference's ``lax.scan``) and the cache is updated IN PLACE (the
  reference donates its buffers): ``forward_with_cache`` writes the new
  K/V into the cache's own tensors and returns a cache object sharing
  them. A caller that must keep a cache as it was clones it first.
- ``KVCache.length`` is a Python int: the host always knows it here.
- Dispatch. On a CUDA tensor the kernels are the rule whenever the
  shapes fit them (bf16, thin rows): the fused QKV+RoPE kernel for the
  decode step's q/k/v, the GEMV (with its residual epilogue) for proj,
  up, down and the tied head, flash-decode for linear, int8 and rolling
  caches at every capacity, and the flash kernel for every empty-cache
  prefill. The ``KFT_DECODE_*`` selectors keep their names; "dense" is
  an explicit A/B choice, never a silent fallback, and forcing a kernel
  on the CPU runs its plain twin (what the parity tests do). The
  thresholds default to 0: re-deriving them on the card is later work.
- Serving records no autograd graph: ``generate``, ``forward_with_cache``
  and the batcher's ``decode_step``/``prefill_slot`` run under
  ``torch.no_grad``, so a trained state's parameters (which require
  grad) are served as they are, with no copy.

- Weight-only int8 (W8A16): :func:`quantize_decode_params` turns every
  projection and the tied embedding into an :class:`Int8Linear`; ``_mm``
  and the fused QKV+RoPE step take it (on the card: the int8 GEMV and
  the int8 qkv_rope kernel), and ``generate(quantize_weights=True)``
  quantises on the way in.

- Rolling caches take mid-sequence chunks (chunked prefill) as the
  reference does: one softmax over the ring as it stood before the chunk
  and the chunk itself, then the chunk's tail is written into the ring
  in place, in two parts where it wraps past the ring's end.
- :class:`StackedDecodeParams` (:func:`stack_decode_params`) holds the
  per-layer weights stacked on a leading layer axis, q/k/v concatenated
  and matmul weights cast to the compute dtype once. The reference runs
  it unrolled or under ``lax.scan``; the port runs it as a loop over the
  layer axis through the same block code as the per-layer params, so the
  two forms give the same numbers (on the card the stacked qkv feeds the
  fused QKV+RoPE kernel directly).

- MoE decode (top-k routing) applies the training layer
  (``transformer.moe_ffn``) to each (B, T) chunk, as the reference does:
  at T = 1 every expert has one slot; a prefill drops over-capacity
  tokens as training does. Expert-choice routing is not causal and is
  refused. ``quantize_decode_params`` leaves the ``moe`` subtree as it
  is and ``stack_decode_params`` refuses MoE, as in the reference.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models.transformer import (
    LMConfig,
    gelu,
    is_moe_block,
    moe_ffn,
    rms_norm,
)
from kubeflow_tpu_torch.ops.attention import (
    apply_rope,
    flash_attention,
    flash_attention_fits,
    mha_reference,
)
from kubeflow_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_fits,
    decode_attention_reference,
)
from kubeflow_tpu_torch.ops.decode_qkv import qkv_rope, qkv_rope_fits
from kubeflow_tpu_torch.ops.gemv import MAX_ROWS, gemv, gemv_fits

NEG_INF = -1e30

# Linear cache capacity rounds up to a multiple of this (the reference's
# cache layout; the CUDA kernels themselves take any capacity).
DECODE_BLOCK = 256


def _choice(name: str, default: str, allowed: tuple[str, ...]) -> str:
    value = os.environ.get(name, default)
    if value not in allowed:
        raise ValueError(f"{name}={value!r} must be {'|'.join(allowed)} "
                         "(a typo here would silently A/B one path "
                         "against itself)")
    return value


def _count(name: str, default: int) -> int:
    raw = os.environ.get(name, str(default))
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} must be an integer") from None
    if value < 0:
        raise ValueError(f"{name}={value} must be >= 0")
    return value


# Selectors, read ONCE at import (a later env change needs a fresh
# process, as in the reference).
DECODE_IMPL = _choice("KFT_DECODE_IMPL", "auto", ("auto", "dense", "kernel"))
PREFILL_IMPL = _choice("KFT_PREFILL_IMPL", "flash", ("flash", "dense"))
DECODE_MM = _choice("KFT_DECODE_MM", "auto", ("auto", "dense", "gemv"))
DECODE_FUSED = _choice("KFT_DECODE_FUSED", "auto", ("auto", "on", "off"))
DECODE_ROLLING_IMPL = _choice("KFT_DECODE_ROLLING_IMPL", "auto",
                              ("auto", "dense", "kernel"))
# Capacities below these take the dense read under "auto". 0 on the
# card: every cache takes flash-decode until the card says otherwise.
DECODE_KERNEL_MIN = _count("KFT_DECODE_KERNEL_MIN", 0)
DECODE_KERNEL_MIN_INT8 = _count("KFT_DECODE_KERNEL_MIN_INT8", 0)
DECODE_ROLLING_MIN = _count("KFT_DECODE_ROLLING_MIN", 0)


def _on_card(t: torch.Tensor) -> bool:
    """The kernels' own dtype on a CUDA tensor: where "auto" takes them."""
    return t.is_cuda and t.dtype == torch.bfloat16


@dataclasses.dataclass
class Int8Linear:
    """Weight-only int8 projection: ``w8`` (K, N) int8, or (N, K) read
    with ``transpose_w`` (the tied embedding), and ``scale`` (N,) f32,
    absmax / 127 per output channel over the contraction axis. Built by
    :func:`quantize_decode_params`; ``_mm`` takes it wherever the decode
    path multiplies a weight."""

    w8: torch.Tensor
    scale: torch.Tensor


def _quantize_linear(w, axis: int) -> Int8Linear:
    """Per-output-channel symmetric int8: scale_n = max(absmax_n, 1e-12)
    / 127 over the contraction ``axis``, then round and clip to ±127."""
    wf = w.detach().float()
    scale = wf.abs().amax(dim=axis).clamp_min(1e-12) / 127.0
    w8 = torch.clamp(torch.round(wf / scale.unsqueeze(axis)), -127,
                     127).to(torch.int8)
    return Int8Linear(w8=w8.contiguous(), scale=scale.contiguous())


def _dense_mm(h, w, transpose_w: bool):
    wf = w.float()
    return h.float() @ (wf.t() if transpose_w else wf)


def _mm(h, kernel, dtype, transpose_w: bool = False, residual=None):
    """Decode-step projection ``h (B, T, D) @ kernel`` routed per
    ``DECODE_MM``. ``kernel`` is a tensor (cast to ``dtype``) or an
    :class:`Int8Linear`. Returns f32, or ``residual + y.to(dtype)`` in the
    residual's dtype when ``residual`` (B, T, N) is given (the GEMV's
    fused epilogue on the kernel path). ``transpose_w`` contracts the
    kernel's LAST axis (the (vocab, D) tied embedding, no copy).

    int8 keeps the reference's op order: with a residual the GEMV takes
    the scale (it must precede the add); without one, ``gemv(h, w8) *
    scale``; the dense path upcasts w8 to ``dtype``, accumulates in f32,
    then scales."""
    quantized = isinstance(kernel, Int8Linear)
    w = kernel.w8 if quantized else kernel.to(dtype)
    b, t, d = h.shape
    n = w.shape[0] if transpose_w else w.shape[1]
    use = gemv_fits(b * t, d, n) and (
        DECODE_MM == "gemv" or (DECODE_MM == "auto" and _on_card(h)))
    if use:
        if residual is not None:
            return gemv(h.reshape(b * t, d), w,
                        scale=kernel.scale if quantized else None,
                        residual=residual.reshape(b * t, n),
                        transpose_w=transpose_w).reshape(b, t, n)
        y = gemv(h.reshape(b * t, d), w,
                 transpose_w=transpose_w).reshape(b, t, n)
    else:
        y = _dense_mm(h, w.to(dtype) if quantized else w, transpose_w)
    if quantized:
        y = y * kernel.scale
    if residual is not None:
        return residual + y.to(dtype)
    return y


def embed_tokens(cfg: LMConfig, emb, tokens):
    """The embedding rows of ``tokens`` in the compute dtype; an int8
    embedding gathers its rows and their per-row scales (the (vocab,)
    scale is per embedding row) and multiplies in the compute dtype."""
    if isinstance(emb, Int8Linear):
        return (emb.w8[tokens].to(cfg.dtype)
                * emb.scale[tokens][..., None].to(cfg.dtype))
    return emb[tokens].to(cfg.dtype)


def _fused_step_wanted(h: torch.Tensor) -> bool:
    return DECODE_FUSED == "on" or (DECODE_FUSED == "auto" and _on_card(h))


def attention_kernel_wanted(cfg: LMConfig, capacity: int, quantized: bool,
                            rolling: bool, q: torch.Tensor) -> bool:
    """THE single-token attention dispatch rule, shared by ``generate``'s
    paths and the continuous batcher so they cannot drift. "auto" takes
    flash-decode for a bf16 CUDA query whose head dim and GQA group the
    kernel was built for, from the capacity threshold (default 0) up;
    "kernel"/"dense" force one path (the kernel on a CPU tensor is its
    plain twin)."""
    impl = DECODE_ROLLING_IMPL if rolling else DECODE_IMPL
    if impl != "auto":
        return impl == "kernel"
    if rolling:
        minimum = DECODE_ROLLING_MIN
    else:
        minimum = DECODE_KERNEL_MIN_INT8 if quantized else DECODE_KERNEL_MIN
    group = cfg.heads // cfg.num_kv_heads
    return (_on_card(q) and capacity >= minimum
            and decode_attention_fits(cfg.head_dim, group))


def kernel_attention(cfg: LMConfig, q, ck, cv, pos, rolling=False, ks=None,
                     vs=None):
    """THE flash-decode invocation, shared by every dispatch site."""
    return decode_attention(q, ck, cv, pos, window=cfg.attn_window,
                            rolling=rolling, k_scale=ks, v_scale=vs)


# Per-block key holding the precomputed concatenated qkv weight.
FUSED_QKV_KEY = "qkv_fused"


def _concat_qkv(cfg: LMConfig, blk):
    """(w, scale): the q/k/v kernels concatenated along the output axis
    in the fused kernel's layout (int8: the payloads and the per-channel
    scales)."""
    kq, kk, kv = (blk[name]["kernel"] for name in ("q_proj", "k_proj",
                                                   "v_proj"))
    if isinstance(kq, Int8Linear):
        return (torch.cat([kq.w8, kk.w8, kv.w8], dim=1).contiguous(),
                torch.cat([kq.scale, kk.scale, kv.scale]).contiguous())
    w = torch.cat([kq, kk, kv], dim=1).to(cfg.dtype)
    return w.contiguous(), None


@torch.no_grad()
def fuse_qkv_params(cfg: LMConfig, params: dict[str, Any],
                    rows: int | None = None) -> dict[str, Any]:
    """Precompute each block's concatenated qkv weight once per params
    version (an engine re-runs its decode step every cycle and would
    otherwise concatenate every layer's q/k/v weights per step).
    Pass-through when the fused step can never run on these params:
    selector off, a dtype or device the kernel does not serve, ``rows``
    past the thin-row bound, or shapes the kernel refuses."""
    probe = torch.empty(0, dtype=cfg.dtype, device=_params_device(params))
    if not _fused_step_wanted(probe):
        return params
    if rows is not None and rows > MAX_ROWS:
        return params
    hq, hkv, hd = cfg.heads, cfg.num_kv_heads, cfg.head_dim
    if not qkv_rope_fits(1, cfg.dim, (hq + 2 * hkv) * hd, hd):
        return params
    out = dict(params)
    for key, blk in params.items():
        if key.startswith("block_") and "q_proj" in blk:
            w, scale = _concat_qkv(cfg, blk)
            out[key] = {**blk, FUSED_QKV_KEY: {"w": w, "scale": scale}}
    return out


def _fused_qkv(cfg: LMConfig, blk, h, pos):
    """The decode step's q/k/v projections + rope in one kernel
    (ops/decode_qkv.py). ``h`` (B, 1, D) post-norm hidden, ``pos`` (B,)
    int32 per-row positions. Returns q/k/v as (B, H[kv], 1, hd), or
    None when the shapes do not fit (caller keeps the unfused chain)."""
    b, t, d = h.shape
    hq, hkv, hd = cfg.heads, cfg.num_kv_heads, cfg.head_dim
    n = (hq + 2 * hkv) * hd
    if t != 1 or not qkv_rope_fits(b, d, n, hd):
        return None
    fused = blk.get(FUSED_QKV_KEY)
    w, scale = ((fused["w"], fused["scale"]) if fused is not None
                else _concat_qkv(cfg, blk))
    out = qkv_rope(h.reshape(b, d), w, pos, scale, head_dim=hd,
                   rope_heads=hq + hkv)
    q = out[:, :hq * hd].reshape(b, hq, 1, hd)
    k = out[:, hq * hd:(hq + hkv) * hd].reshape(b, hkv, 1, hd)
    v = out[:, (hq + hkv) * hd:].reshape(b, hkv, 1, hd)
    return q, k, v


@dataclasses.dataclass
class KVCache:
    """Per-layer stacked K/V buffers + the filled length.

    ``k``/``v``: (layers, B, kv_heads, capacity, head_dim); ``length``
    the tokens written so far. ``rolling=True`` (requires
    ``cfg.attn_window``) makes a window-sized ring: position p lives in
    slot ``p % capacity``. ``quantized=True`` stores int8 payloads with
    per-row absmax scales ``k_scale``/``v_scale``
    (layers, B, kv_heads, capacity, 1) f32. ``empty`` is True only on
    the cache ``init`` returns: it selects the empty-cache prefill."""

    k: torch.Tensor
    v: torch.Tensor
    length: int
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None
    rolling: bool = False
    empty: bool = False

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def init(cls, cfg: LMConfig, batch: int, max_len: int,
             rolling: bool = False, quantized: bool = False,
             device=None) -> "KVCache":
        dev = resolve_device(device)
        if rolling:
            if cfg.attn_window is None:
                raise ValueError(
                    "rolling cache requires cfg.attn_window (a full-"
                    "attention model needs every past position)")
            capacity = min(cfg.attn_window, max_len)
        else:
            capacity = max_len
            if capacity > DECODE_BLOCK and capacity % DECODE_BLOCK:
                capacity += DECODE_BLOCK - capacity % DECODE_BLOCK
        shape = (cfg.layers, batch, cfg.num_kv_heads, capacity, cfg.head_dim)
        dtype = torch.int8 if quantized else cfg.dtype
        scale_shape = shape[:-1] + (1,)

        def scales():
            return (torch.zeros(scale_shape, dtype=torch.float32, device=dev)
                    if quantized else None)

        return cls(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   length=0, k_scale=scales(), v_scale=scales(),
                   rolling=rolling, empty=True)

    def clone(self) -> "KVCache":
        """A private copy: the port writes caches in place, so a shared
        cache (a prefix-cache entry) is cloned before its first write."""
        copy = lambda t: None if t is None else t.clone()  # noqa: E731
        return dataclasses.replace(self, k=copy(self.k), v=copy(self.v),
                                   k_scale=copy(self.k_scale),
                                   v_scale=copy(self.v_scale))


@dataclasses.dataclass
class StackedDecodeParams:
    """Decode-time view of the params: per-layer weights stacked on a
    leading layer axis, the q/k/v kernels concatenated into one (the
    fused QKV+RoPE kernel's layout), and every matmul weight cast to the
    compute dtype once. Norm scales stay f32. Build with
    :func:`stack_decode_params`; pass it wherever
    ``forward_with_cache``/``generate`` take ``params``. The layers run
    as a loop over the leading axis (the reference's ``scan`` option has
    no counterpart here)."""

    norm0: torch.Tensor      # (L, D) f32
    qkv: torch.Tensor        # (L, D, (H + 2*Hkv) * hd) compute dtype
    proj: torch.Tensor       # (L, H*hd, D)
    norm1: torch.Tensor      # (L, D) f32
    up: torch.Tensor         # (L, D, F)
    down: torch.Tensor       # (L, F, D)
    embed: torch.Tensor      # (V, D) compute dtype (the tied head too)
    final_norm: torch.Tensor  # (D,) f32


@torch.no_grad()
def stack_decode_params(cfg: LMConfig,
                        params: dict[str, Any]) -> StackedDecodeParams:
    """One-time restructure of the training params for the stacked
    decode form; do it outside any decode loop."""
    if cfg.moe_experts:
        raise ValueError(
            "MoE blocks are heterogeneous (dense FFN / MoE alternate); the "
            "stacked decode form requires uniform layers - pass the raw "
            "params instead")
    if isinstance(params["embed"]["embedding"], Int8Linear):
        raise ValueError(
            "stack_decode_params takes the raw training params; int8 decode "
            "weights (quantize_decode_params) run the unrolled path")
    dt = cfg.dtype
    blocks = [params[f"block_{i}"] for i in range(cfg.layers)]

    def stack(name, sub="kernel", dtype=None):
        out = torch.stack([blk[name][sub] for blk in blocks])
        return out if dtype is None else out.to(dtype)

    qkv = torch.stack([
        torch.cat([blk[name]["kernel"] for name in ("q_proj", "k_proj",
                                                    "v_proj")], dim=1)
        for blk in blocks]).to(dt)
    return StackedDecodeParams(
        norm0=stack("RMSNorm_0", "scale"), qkv=qkv,
        proj=stack("proj", dtype=dt), norm1=stack("RMSNorm_1", "scale"),
        up=stack("up", dtype=dt), down=stack("down", dtype=dt),
        embed=params["embed"]["embedding"].to(dt),
        final_norm=params["final_norm"]["scale"])


def _layer_views(cfg: LMConfig, sp: StackedDecodeParams) -> dict[str, Any]:
    """The per-layer params dict over views of the stacked tensors: layer
    i is index i of the leading axis. A view carries its qkv only as the
    block's fused weight (no q/k/v entries): ``_block_step`` runs one
    matmul on it, as the reference's stacked scan does."""
    out: dict[str, Any] = {"embed": {"embedding": sp.embed},
                           "final_norm": {"scale": sp.final_norm}}
    for i in range(cfg.layers):
        out[f"block_{i}"] = {
            "RMSNorm_0": {"scale": sp.norm0[i]},
            FUSED_QKV_KEY: {"w": sp.qkv[i], "scale": None},
            "proj": {"kernel": sp.proj[i]},
            "RMSNorm_1": {"scale": sp.norm1[i]},
            "up": {"kernel": sp.up[i]},
            "down": {"kernel": sp.down[i]},
        }
    return out


def _quantize_rows(x):
    """(B, Hkv, T, hd) -> int8 payload + per-row absmax scale
    (B, Hkv, T, 1), symmetric: row_max / 127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _prefill_attention(cfg: LMConfig, q, k, v):
    """Empty-cache prefill: the chunk attends to itself. On the card the
    flash kernel, at every length; elsewhere the plain reference."""
    if _on_card(q) and flash_attention_fits(cfg.head_dim):
        return flash_attention(q, k, v, causal=True, window=cfg.attn_window)
    return mha_reference(q, k, v, causal=True, window=cfg.attn_window)


def _decode_attention(cfg: LMConfig, q, ck, cv, pos, ks=None, vs=None):
    """Single-token decode over a linear cache: flash-decode where
    :func:`attention_kernel_wanted` says so, else the dense masked read."""
    if attention_kernel_wanted(cfg, ck.shape[2], ks is not None, False, q):
        return kernel_attention(cfg, q, ck, cv, pos, ks=ks, vs=vs)
    return _cached_attention(cfg, q, ck, cv, pos, 1, ks, vs)


def _rolling_attention(cfg: LMConfig, q, ck, cv, pos, ks=None, vs=None):
    """Single-token decode over a ring: slot j holds the newest global
    position ≡ j (mod capacity) that is <= pos; slots whose position is
    negative are unwritten. capacity <= window keeps every written slot
    in-band, so there is no window mask."""
    if attention_kernel_wanted(cfg, ck.shape[2], ks is not None, True, q):
        return kernel_attention(cfg, q, ck, cv, pos, rolling=True, ks=ks,
                                vs=vs)
    return decode_attention_reference(q, ck, cv, pos, window=None,
                                      k_scale=ks, v_scale=vs, rolling=True)


def _cached_attention(cfg: LMConfig, q, ck, cv, pos, t, ks=None, vs=None):
    """q (B, H, T, hd) at global positions [pos, pos+T) against the
    whole (B, Hkv, L, hd) cache: dense masked read, valid iff col <= the
    row's position (and inside the window). Operands in the compute
    dtype with f32 accumulation; the softmax weights go back to the
    compute dtype for the PV product. ``ks``/``vs`` dequantise int8."""
    b, h, _, hd = q.shape
    hkv = ck.shape[1]
    group = h // hkv
    compute = q.dtype
    qg = q.reshape(b, hkv, group, t, hd).float()
    s = torch.einsum("bkgtd,bkld->bkgtl", qg,
                     ck.to(compute).float()) * hd ** -0.5
    if ks is not None:
        s = s * ks[..., 0][:, :, None, None, :]
    rows = pos + torch.arange(t, device=q.device)[:, None]
    cols = torch.arange(ck.shape[2], device=q.device)[None, :]
    keep = cols <= rows
    if cfg.attn_window is not None:
        keep = keep & (cols > rows - cfg.attn_window)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    if vs is not None:
        w = w * vs[..., 0][:, :, None, None, :]
    out = torch.einsum("bkgtl,bkld->bkgtd", w.to(compute).float(),
                       cv.to(compute).float())
    return out.reshape(b, h, t, hd).to(q.dtype)


def _rolling_chunk_attention(cfg: LMConfig, q, k, v, ck, cv, pos: int,
                             ks=None, vs=None):
    """Mid-sequence multi-token chunk over a ring: one softmax over both
    key sources, the ring as it stood BEFORE the chunk (slot j holds the
    newest position ≡ j (mod capacity) that is < pos) and the chunk
    itself (causal + window). The caller writes the chunk after this
    read: writing first would evict positions the chunk's earliest
    queries still need. q (B, H, T, hd); k/v (B, Hkv, T, hd) the fresh,
    unquantised chunk keys; ck/cv (B, Hkv, capacity, hd) the ring with
    optional per-row int8 scales ks/vs."""
    b, h, t, hd = q.shape
    hkv, capacity = ck.shape[1], ck.shape[2]
    window = cfg.attn_window
    compute = q.dtype
    qg = q.reshape(b, hkv, h // hkv, t, hd).float()
    scale = hd ** -0.5
    dev = q.device

    s_cache = torch.einsum("bkgtd,bkld->bkgtl", qg,
                           ck.to(compute).float()) * scale
    if ks is not None:
        s_cache = s_cache * ks[..., 0][:, :, None, None, :]
    newest = pos - 1
    cache_pos = newest - torch.remainder(
        newest - torch.arange(capacity, device=dev), capacity)
    rows = pos + torch.arange(t, device=dev)[:, None]
    keep = (cache_pos >= 0) & (cache_pos > rows - window)
    s_cache = torch.where(keep, s_cache, torch.full_like(s_cache, NEG_INF))

    s_self = torch.einsum("bkgtd,bkcd->bkgtc", qg,
                          k.to(compute).float()) * scale
    r = torch.arange(t, device=dev)[:, None]
    c = torch.arange(t, device=dev)[None, :]
    keep = (c <= r) & (c > r - window)
    s_self = torch.where(keep, s_self, torch.full_like(s_self, NEG_INF))

    w = torch.softmax(torch.cat([s_cache, s_self], dim=-1), dim=-1)
    w_cache, w_self = w[..., :capacity], w[..., capacity:]
    if vs is not None:
        w_cache = w_cache * vs[..., 0][:, :, None, None, :]
    out = (torch.einsum("bkgtl,bkld->bkgtd", w_cache.to(compute).float(),
                        cv.to(compute).float())
           + torch.einsum("bkgtc,bkcd->bkgtd", w_self.to(compute).float(),
                          v.to(compute).float()))
    return out.reshape(b, h, t, hd).to(q.dtype)


def _write_rolling_chunk(cache_buf, chunk, pos: int, capacity: int) -> None:
    """Write a chunk at global positions [pos, pos + T) into the ring in
    place: position p goes to slot p % capacity, and only the last
    min(T, capacity) positions are kept (the rest are already evicted).
    The kept run starts at slot (pos + T - kept) % capacity and, where it
    passes the ring's end, goes on at slot 0."""
    t = chunk.shape[2]
    kept = min(t, capacity)
    tail = chunk[:, :, t - kept:]
    start = (pos + t - kept) % capacity
    first = min(kept, capacity - start)
    cache_buf[:, :, start:start + first] = tail[:, :, :first]
    if first < kept:
        cache_buf[:, :, :kept - first] = tail[:, :, first:]


def _attend_and_cache(cfg: LMConfig, q, k, v, ck, cv, pos: int, empty: bool,
                      rolling: bool, ks_buf=None, vs_buf=None):
    """The shared middle of one block: quantise the new K/V if the cache
    is int8, write them (in place) at the right slots, and run the
    attention variant (t, empty, rolling) calls for. q/k/v are
    (B, H[kv], T, hd) post-rope. Returns (B, H, T, hd)."""
    t = q.shape[2]
    quantized = ks_buf is not None
    capacity = ck.shape[2]
    if quantized:
        k_store, k_s = _quantize_rows(k)
        v_store, v_s = _quantize_rows(v)
    else:
        k_store, v_store, k_s, v_s = k, v, None, None

    def write(at: int) -> None:
        ck[:, :, at:at + t] = k_store
        cv[:, :, at:at + t] = v_store
        if quantized:
            ks_buf[:, :, at:at + t] = k_s
            vs_buf[:, :, at:at + t] = v_s

    if t == 1:
        write(pos % capacity if rolling else pos)
        if rolling:
            return _rolling_attention(cfg, q, ck, cv, pos, ks_buf, vs_buf)
        return _decode_attention(cfg, q, ck, cv, pos, ks_buf, vs_buf)
    if empty and not rolling:
        # Empty-cache prefill (pos == 0): the chunk attends to itself on
        # the UNQUANTISED k/v; the cache write happens on the side.
        write(0)
        if PREFILL_IMPL == "dense" and not quantized:
            return _cached_attention(cfg, q, ck, cv, pos, t)
        return _prefill_attention(cfg, q, k, v)
    if rolling:
        # An empty ring attends to the chunk alone (the flash kernel on
        # the card); a filled one reads the ring as it stood and the
        # chunk in one softmax. Either way the chunk's tail is written
        # after the read.
        out = (_prefill_attention(cfg, q, k, v) if empty else
               _rolling_chunk_attention(cfg, q, k, v, ck, cv, pos, ks_buf,
                                        vs_buf))
        for buf, chunk in ((ck, k_store), (cv, v_store), (ks_buf, k_s),
                           (vs_buf, v_s)):
            if buf is not None:
                _write_rolling_chunk(buf, chunk, pos, capacity)
        return out
    # Mid-sequence chunk on a linear cache: dense masked read.
    write(pos)
    return _cached_attention(cfg, q, ck, cv, pos, t, ks_buf, vs_buf)


def _block_step(cfg: LMConfig, blk, x, ck, cv, pos: int, empty: bool,
                rolling: bool, ks_buf=None, vs_buf=None, use_moe=False):
    """One block over a (B, T, D) chunk at global offset ``pos``,
    updating this layer's cache slices in place. Single-token steps take
    the fused QKV+RoPE kernel where wanted, and the out/down projections
    carry their residual adds in the GEMV epilogue. An MoE block
    (``use_moe``) runs the training layer on the chunk in place of
    up/down (routing is position-independent; no aux is collected)."""
    b, t, _ = x.shape
    h = rms_norm(blk["RMSNorm_0"]["scale"], x)
    fused = None
    if t == 1 and _fused_step_wanted(h):
        pos_vec = torch.full((b,), pos, dtype=torch.int32, device=x.device)
        fused = _fused_qkv(cfg, blk, h, pos_vec)
    hq, hkv = cfg.heads, cfg.num_kv_heads
    if fused is not None:
        q, k, v = fused
    elif "q_proj" not in blk:  # a stacked layer view: one qkv matmul
        y = _mm(h, blk[FUSED_QKV_KEY]["w"], cfg.dtype).to(cfg.dtype)
        y = y.reshape(b, t, hq + 2 * hkv, cfg.head_dim).transpose(1, 2)
        q = apply_rope(y[:, :hq], offset=pos)
        k = apply_rope(y[:, hq:hq + hkv], offset=pos)
        v = y[:, hq + hkv:]
    else:
        def proj(name, n):
            y = _mm(h, blk[name]["kernel"], cfg.dtype).to(cfg.dtype)
            return y.reshape(b, t, n, cfg.head_dim).transpose(1, 2)

        q = apply_rope(proj("q_proj", hq), offset=pos)
        k = apply_rope(proj("k_proj", hkv), offset=pos)
        v = proj("v_proj", hkv)
    out = _attend_and_cache(cfg, q, k, v, ck, cv, pos, empty, rolling,
                            ks_buf, vs_buf)
    out = out.transpose(1, 2).reshape(b, t, cfg.dim)
    x = _mm(out, blk["proj"]["kernel"], cfg.dtype, residual=x)
    h = rms_norm(blk["RMSNorm_1"]["scale"], x)
    if use_moe:
        return x + moe_ffn(cfg, blk["moe"], h)
    h = gelu(_mm(h, blk["up"]["kernel"], cfg.dtype).to(cfg.dtype))
    return _mm(h, blk["down"]["kernel"], cfg.dtype, residual=x)


def _refuse_expert_choice(cfg: LMConfig) -> None:
    if cfg.moe_experts and cfg.moe_router == "expert_choice":
        raise NotImplementedError(
            "expert-choice routing selects tokens ACROSS the sequence "
            "(experts pick their top-C tokens), which is not causal - "
            "autoregressive decode requires topk routing")


def _params_device(params) -> torch.device:
    emb = params["embed"]["embedding"]
    return (emb.w8 if isinstance(emb, Int8Linear) else emb).device


@torch.no_grad()
def quantize_decode_params(cfg: LMConfig,
                           params: dict[str, Any]) -> dict[str, Any]:
    """Weight-only int8 view of the training params for decoding (W8A16:
    int8 weights, bf16 activations, f32 accumulation), same nesting, so
    it goes wherever ``forward_with_cache``/``generate``/the engines take
    ``params``. q/k/v/proj/up/down quantise along axis 0 (their input
    axis), the tied embedding along axis 1; norms stay f32, and an MoE
    block's ``moe`` subtree is left as it is (the MoE layer runs the
    training layer). A ``qkv_fused`` entry of the float weights is
    dropped: quantise first, fuse after."""
    quant = {"q_proj", "k_proj", "v_proj", "proj", "up", "down"}
    out: dict[str, Any] = {}
    for key, sub in params.items():
        if key.startswith("block_"):
            out[key] = {name: ({"kernel": _quantize_linear(leaf["kernel"],
                                                           axis=0)}
                               if name in quant else leaf)
                        for name, leaf in sub.items()
                        if name != FUSED_QKV_KEY}
        elif key == "embed":
            out[key] = {"embedding": _quantize_linear(sub["embedding"],
                                                      axis=1)}
        else:
            out[key] = sub
    return out


@torch.no_grad()
def forward_with_cache(cfg: LMConfig, params: dict[str, Any], tokens,
                       cache: KVCache, last_logits_only: bool = False,
                       device=None):
    """Run ``tokens`` (B, T) from the cache's current length; returns
    (logits (B, T, vocab) f32, the advanced cache). The cache's tensors
    are written IN PLACE; the returned cache shares them.
    ``last_logits_only`` computes the head for the final position only
    ((B, 1, vocab)), what a prefill-then-sample caller needs. ``params``
    is the per-layer dict or a :class:`StackedDecodeParams`."""
    dev = resolve_device(device)
    _refuse_expert_choice(cfg)
    if isinstance(params, StackedDecodeParams):
        params = _layer_views(cfg, params)
    if _params_device(params) != dev or cache.k.device != dev:
        raise ValueError(f"params and cache must be on {dev}")
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = cache.length
    capacity = cache.k.shape[3]
    if not cache.rolling and pos + tokens.shape[1] > capacity:
        raise ValueError(f"cache overflow: length {pos} + {tokens.shape[1]} "
                         f"new tokens > max_len {capacity}")
    emb = params["embed"]["embedding"]
    x = embed_tokens(cfg, emb, tokens)
    quantized = cache.quantized
    for i in range(cfg.layers):
        x = _block_step(
            cfg, params[f"block_{i}"], x, cache.k[i], cache.v[i], pos,
            cache.empty, cache.rolling,
            ks_buf=cache.k_scale[i] if quantized else None,
            vs_buf=cache.v_scale[i] if quantized else None,
            use_moe=is_moe_block(cfg, i))
    x = rms_norm(params["final_norm"]["scale"], x)
    if last_logits_only:
        x = x[:, -1:]
    logits = _mm(x.to(cfg.dtype), emb, cfg.dtype, transpose_w=True)
    return logits, dataclasses.replace(cache, length=pos + tokens.shape[1],
                                       empty=False)


def make_generator(rng, device) -> torch.Generator:
    """A request's sampling stream: a ``torch.Generator`` as given, or
    one seeded from an integer on ``device``."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(int(rng))


def gumbel_noise(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise from ``gen``: argmax(logits / t + g) draws
    from softmax(logits / t)."""
    u = torch.rand(shape, generator=gen, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


@torch.no_grad()
def generate(cfg: LMConfig, params: dict[str, Any], prompt,
             max_new_tokens: int, temperature: float = 0.0, rng=None,
             quantize_cache: bool = False, quantize_weights: bool = False,
             device=None) -> torch.Tensor:
    """Greedy (temperature 0) or sampled generation. ``prompt`` (B, P)
    int; returns (B, max_new_tokens) int32 on the device. ``rng`` (an
    int seed or a ``torch.Generator``) is required when sampling: each
    token draws Gumbel noise from it, first token first.
    ``quantize_weights`` decodes through :func:`quantize_decode_params`
    of ``params`` (the raw training params); quantised params, or a
    :class:`StackedDecodeParams`, can as well be passed directly."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    _refuse_expert_choice(cfg)
    if temperature > 0.0 and rng is None:
        raise ValueError("temperature > 0 samples; pass rng (an int seed or "
                         "a torch.Generator) - a fixed default would return "
                         "identical samples on every call")
    if quantize_weights:
        if isinstance(params, StackedDecodeParams):
            raise ValueError("quantize_weights takes the raw training "
                             "params, not StackedDecodeParams")
        if isinstance(params["embed"]["embedding"], Int8Linear):
            raise ValueError("quantize_weights takes the raw training "
                             "params; these are already quantised")
        params = quantize_decode_params(cfg, params)
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, p = prompt.shape
    total = p + max_new_tokens - 1
    rolling = cfg.attn_window is not None and cfg.attn_window < total
    cache = KVCache.init(cfg, b, total, rolling=rolling,
                         quantized=quantize_cache, device=dev)
    gen = make_generator(rng, dev) if temperature > 0.0 else None

    def sample(logits_last):
        if gen is None:
            return torch.argmax(logits_last, dim=-1).to(torch.int32)
        noise = gumbel_noise(gen, logits_last.shape, dev)
        return torch.argmax(logits_last / temperature + noise,
                            dim=-1).to(torch.int32)

    logits, cache = forward_with_cache(cfg, params, prompt, cache,
                                       last_logits_only=True, device=dev)
    tokens = [sample(logits[:, -1])]
    for _ in range(max_new_tokens - 1):
        logits, cache = forward_with_cache(
            cfg, params, tokens[-1][:, None], cache, device=dev)
        tokens.append(sample(logits[:, -1]))
    return torch.stack(tokens, dim=1)

"""Attention: the flash kernels (forward and backward), their plain
twins, and RoPE.

The counterpart of ``kubeflow_tpu/ops/attention.py``. q is
(batch, heads, seq, head_dim) and k/v (batch, kv_heads, seq, head_dim);
GQA maps q head ``h`` onto kv head ``h // (heads // kv_heads)``.

:func:`flash_attention` is differentiable, as the reference's custom VJP
is: when a gradient is wanted the forward also stores each row's
logsumexp (lse), and the backward runs delta = rowsum(dO * O), then the
dq pass and the dk/dv pass (the FlashAttention-2 two-kernel scheme).
Causal with an optional window band, or non-causal, with an optional
segment-id document mask. On a CUDA tensor each pass launches its kernel
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) or raises; on a CPU
tensor it runs its plain twin (:func:`flash_forward_reference`,
:func:`flash_dq_reference`, :func:`flash_dkv_reference`), which keep the
kernels' rounding points: s = (q . k in f32) * scale, p rounded to the
input dtype before the PV and dv products, ds rounded before the dq and
dk products. :func:`mha_reference` stays the plain f32 attention.

A row with no live key cannot occur in self-attention (its diagonal is
live under every mask here); with Sq > Sk under a window it can. Such a
row gets o = 0, lse = -1e30 and zero gradient: forward and backward mask
p explicitly instead of relying on exp underflow. (The JAX kernel gives
such a row the mean of V over any live block that reaches it, a result
that depends on its block size.)
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops import _build

# Finite "minus infinity": exp(NEG_INF - m) underflows to 0, not NaN.
NEG_INF = -1e30


def _causal_mask(scores, q_offset=0, k_offset=0, window=None):
    """Causal mask, optionally banded: with ``window`` W, row r attends
    to cols in [r-W+1, r] (W=1 is self-attention only)."""
    return torch.where(_live(scores.shape[-2], scores.shape[-1], True,
                             window, None, scores.device, q_offset,
                             k_offset),
                       scores, torch.full_like(scores, NEG_INF))


def _live(sq, sk, causal, window, segment_ids, device, q_offset=0,
          k_offset=0):
    """The (row, key) pairs attention may use: (Sq, Sk), or (B, 1, Sq,
    Sk) with ``segment_ids``."""
    rows = q_offset + torch.arange(sq, device=device)[:, None]
    cols = k_offset + torch.arange(sk, device=device)[None, :]
    keep = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        keep = rows >= cols
        if window is not None:
            keep = keep & (cols > rows - window)
    if segment_ids is not None:
        keep = keep & (segment_ids[:, None, :, None]
                       == segment_ids[:, None, None, :])
    return keep


def _check_window(causal, window):
    if window is not None:
        if not causal:
            raise ValueError("window requires causal attention")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def mha_reference(q, k, v, causal=False, scale=None, q_offset=0,
                  k_offset=0, window=None, segment_ids=None):
    """Plain attention in f32. q: (..., Sq, D), k/v: (..., Sk, D).
    ``window`` is the sliding-window width (requires causal);
    ``segment_ids`` (B, S) the document mask for packed batches."""
    _check_window(causal, window)
    if q.ndim == 4 and k.ndim == 4 and k.shape[-3] != q.shape[-3]:
        if q.shape[-3] % k.shape[-3]:
            raise ValueError(f"q heads {q.shape[-3]} not a multiple of kv "
                             f"heads {k.shape[-3]}")
        group = q.shape[-3] // k.shape[-3]
        k = k.repeat_interleave(group, dim=-3)
        v = v.repeat_interleave(group, dim=-3)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if causal:
        s = _causal_mask(s, q_offset, k_offset, window)
    if segment_ids is not None:
        if q.ndim != 4:
            raise ValueError("segment_ids requires the (B, H, S, D) layout, "
                             f"got q.ndim={q.ndim}")
        keep = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", w, v.float()).to(q.dtype)


def check_segment_ids(segment_ids) -> None:
    """The packed-batch contract: ids non-decreasing along the sequence.
    One host sync; the model checks once per batch, not per layer."""
    if bool((segment_ids[:, 1:] < segment_ids[:, :-1]).any()):
        raise ValueError(
            "segment_ids must be non-decreasing along the sequence "
            "(packed-batch layout); unsorted ids would make the "
            "tile-skip predicate drop live tiles - use mha_reference "
            "for arbitrary masks")


def _check_flash(q, k, v, causal, window, segment_ids):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (batch, heads, seq, dim)")
    _check_window(causal, window)
    if q.shape[1] % k.shape[1] or k.shape[1:] != v.shape[1:]:
        raise ValueError(
            f"q heads {q.shape[1]} must be a multiple of kv heads "
            f"{k.shape[1]}; k/v must agree (got {tuple(k.shape)} vs "
            f"{tuple(v.shape)})")
    if (q.shape[0] != k.shape[0] or q.shape[0] != v.shape[0]
            or q.shape[-1] != k.shape[-1]):
        raise ValueError(f"q batch/head_dim must match k/v: got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (q.shape[0], q.shape[2]):
            raise ValueError(
                f"segment_ids must be (batch, seq) = ({q.shape[0]}, "
                f"{q.shape[2]}), got {tuple(segment_ids.shape)}")
        if k.shape[2] != q.shape[2]:
            raise ValueError("segment_ids requires self-attention (q and k "
                             "share one sequence)")
        check_segment_ids(segment_ids)


FLASH_HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention_fits(head_dim: int) -> bool:
    """True when the kernels were built for this head dim."""
    return head_dim in FLASH_HEAD_DIMS


def _kernel_inputs(kernel, q, k, v, segment_ids, *rest):
    """Validate and lay out a CUDA call: head dim, bf16, contiguous, one
    card (anything else raises; nothing falls back to a twin)."""
    if not flash_attention_fits(q.shape[-1]):
        raise ValueError(f"flash kernels are built for head dims "
                         f"{FLASH_HEAD_DIMS}, got {q.shape[-1]}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"{kernel} takes bf16 q/k/v")
    seg = (segment_ids.to(torch.int32).contiguous()
           if segment_ids is not None else None)
    tensors = [t.contiguous() for t in (q, k, v, *rest)]
    _build.require_cuda(kernel, *tensors, seg)
    return tensors, seg


def _scale(q, scale) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


# ---- plain twins --------------------------------------------------------


def _twin_scores(q, k, causal, window, segment_ids, scale):
    """f32 scores s = (q . k) * scale over k repeated to q's heads, and
    the live mask (broadcastable to s)."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    keep = _live(q.shape[2], k.shape[2], causal, window, segment_ids,
                 q.device)
    return s, keep


def flash_forward_reference(q, k, v, *, causal=False, window=None,
                            segment_ids=None, scale=None):
    """The forward kernel's plain twin: (o in q.dtype, lse (B, H, Sq)
    f32), with p rounded to v.dtype before the PV product and 0 on a
    masked pair (a row with no live key: o = 0, lse = -1e30)."""
    scale = _scale(q, scale)
    s, keep = _twin_scores(q, k, causal, window, segment_ids, scale)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    group = q.shape[1] // k.shape[1]
    vf = v.float().repeat_interleave(group, dim=1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vf) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def _twin_p_ds(q, k, v, do, lse, delta, causal, window, segment_ids,
               scale):
    """p = exp(s - lse) (0 where masked) and ds = p * (dp - delta) *
    scale, (B, H, Sq, Sk) f32, k/v repeated to q's heads."""
    s, keep = _twin_scores(q, k, causal, window, segment_ids, scale)
    p = torch.where(keep, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    group = q.shape[1] // k.shape[1]
    vf = v.float().repeat_interleave(group, dim=1)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vf)
    return p, p * (dp - delta[..., None]) * scale


def flash_dq_reference(q, k, v, do, lse, delta, *, causal=False,
                       window=None, segment_ids=None, scale=None):
    """The dq kernel's plain twin: dq = bf16(ds) . K, in q.dtype."""
    scale = _scale(q, scale)
    _, ds = _twin_p_ds(q, k, v, do, lse, delta, causal, window,
                       segment_ids, scale)
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(q.dtype).float(), kf)
    return dq.to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, *, causal=False,
                        window=None, segment_ids=None, scale=None):
    """The dk/dv kernel's plain twin: dk = bf16(ds)^T . Q and dv =
    bf16(p)^T . dO, each summed over the query group in f32 and rounded
    once, (B, Hkv, Sk, D) in k.dtype / v.dtype."""
    scale = _scale(q, scale)
    p, ds = _twin_p_ds(q, k, v, do, lse, delta, causal, window,
                       segment_ids, scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do.float())
    b, hkv, sk, d = k.shape

    def group_sum(t):
        return t.reshape(b, hkv, -1, sk, d).sum(dim=2)

    return group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


# ---- kernel wrappers ----------------------------------------------------


def _forward(q, k, v, causal, window, segment_ids, scale, with_lse):
    """(o, lse or None): the forward kernel, with the lse output only
    when asked (inference stores none)."""
    if q.device.type == "cpu":
        o, lse = flash_forward_reference(q, k, v, causal=causal,
                                         window=window,
                                         segment_ids=segment_ids,
                                         scale=scale)
        return o, (lse if with_lse else None)
    (q, k, v), seg = _kernel_inputs("flash_attention", q, k, v, segment_ids)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    status = _build.library().kft_flash_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(seg),
        _build.ptr(out), _build.ptr(lse), b, h, k.shape[1], sq, k.shape[2],
        d, int(causal), int(window or 0), scale,
        _build.stream_ptr(q.device))
    _build.check(status, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_forward(q, k, v, *, causal=False, window=None, segment_ids=None,
                  scale=None):
    """The forward with the per-row logsumexp: (o, lse (B, H, Sq) f32),
    the reference's ``_flash_forward(with_lse=True)``. Like every public
    entry here it checks its inputs, segment-id order included."""
    _check_flash(q, k, v, causal, window, segment_ids)
    return _forward(q, k, v, causal, window, segment_ids, _scale(q, scale),
                    with_lse=True)


def _check_backward(q, do, lse, delta):
    b, h, sq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must match q: {tuple(do.shape)} {do.dtype} "
                         f"vs {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be (batch, heads, seq) = "
                             f"({b}, {h}, {sq}) f32, got {tuple(t.shape)} "
                             f"{t.dtype}")


def _dq(q, k, v, do, lse, delta, causal, window, segment_ids, scale):
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, do, lse, delta, causal=causal,
                                  window=window, segment_ids=segment_ids,
                                  scale=scale)
    (q, k, v, do, lse, delta), seg = _kernel_inputs(
        "flash_dq", q, k, v, segment_ids, do, lse, delta)
    b, h, sq, d = q.shape
    dq = torch.empty_like(q)
    status = _build.library().kft_flash_dq(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
        _build.ptr(lse), _build.ptr(delta), _build.ptr(seg), _build.ptr(dq),
        b, h, k.shape[1], sq, k.shape[2], d, int(causal), int(window or 0),
        scale, _build.stream_ptr(q.device))
    _build.check(status, "flash_dq")
    _build.LAUNCHES["flash_dq"] += 1
    return dq


def flash_dq(q, k, v, do, lse, delta, *, causal=False, window=None,
             segment_ids=None, scale=None):
    """dq of attention (the reference's ``_dq_kernel``): q/do (B, H, Sq,
    D), k/v (B, Hkv, Sk, D), lse/delta (B, H, Sq) f32 -> dq like q."""
    _check_flash(q, k, v, causal, window, segment_ids)
    _check_backward(q, do, lse, delta)
    return _dq(q, k, v, do, lse, delta, causal, window, segment_ids,
               _scale(q, scale))


def _dkv(q, k, v, do, lse, delta, causal, window, segment_ids, scale):
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, do, lse, delta, causal=causal,
                                   window=window, segment_ids=segment_ids,
                                   scale=scale)
    (q, k, v, do, lse, delta), seg = _kernel_inputs(
        "flash_dkv", q, k, v, segment_ids, do, lse, delta)
    b, h, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    status = _build.library().kft_flash_dkv(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
        _build.ptr(lse), _build.ptr(delta), _build.ptr(seg), _build.ptr(dk),
        _build.ptr(dv), b, h, k.shape[1], sq, k.shape[2], d, int(causal),
        int(window or 0), scale, _build.stream_ptr(q.device))
    _build.check(status, "flash_dkv")
    _build.LAUNCHES["flash_dkv"] += 1
    return dk, dv


def flash_dkv(q, k, v, do, lse, delta, *, causal=False, window=None,
              segment_ids=None, scale=None):
    """(dk, dv) of attention (the reference's ``_dkv_kernel``), each
    (B, Hkv, Sk, D), the query group summed inside the kernel."""
    _check_flash(q, k, v, causal, window, segment_ids)
    _check_backward(q, do, lse, delta)
    return _dkv(q, k, v, do, lse, delta, causal, window, segment_ids,
                _scale(q, scale))


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: the forward keeps (q, k, v,
    o, lse); the backward runs delta, then dq, then dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, window, scale):
        out, lse = _forward(q, k, v, causal, window, segment_ids, scale,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, segment_ids, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        g = g.contiguous()
        delta = (g.float() * out.float()).sum(dim=-1)
        mask = (causal, window, segment_ids, scale)
        dq = _dq(q, k, v, g, lse, delta, *mask)
        dk, dv = _dkv(q, k, v, g, lse, delta, *mask)
        return dq, dk, dv, None, None, None, None


def _attend(q, k, v, causal, window, segment_ids, scale=None):
    """:func:`flash_attention` past its checks, for a caller that made
    them once per batch (the model: one segment-order host sync per
    forward, not one per layer). The kernels still refuse a dtype or head
    dim they were not built for."""
    scale = _scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, segment_ids, causal, window, scale)
    return _forward(q, k, v, causal, window, segment_ids, scale,
                    with_lse=False)[0]


def flash_attention(q, k, v, *, causal=False, window=None,
                    segment_ids=None, scale=None):
    """Tiled attention. q/k/v: (batch, heads, seq, head_dim). Returns o
    in q.dtype; differentiable in q, k and v. ``segment_ids`` must be
    non-decreasing along the sequence (checked: one host sync)."""
    _check_flash(q, k, v, causal, window, segment_ids)
    return _attend(q, k, v, causal, window, segment_ids, scale)


# ---- rotary position embeddings ----------------------------------------


def rope_table(seq_len: int, head_dim: int, base: float = 10000.0,
               offset=0, device=None):
    """(cos, sin) tables of shape (seq_len, head_dim // 2); with a (B,)
    tensor ``offset`` (per-row positions) the tables are
    (B, 1, seq_len, head_dim // 2), ready to broadcast over heads."""
    half = head_dim // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=device) / half)
    steps = torch.arange(seq_len, dtype=torch.float32, device=device)
    if isinstance(offset, torch.Tensor):  # (B,) per-row offsets
        pos = offset.to(torch.float32)[:, None] + steps[None, :]
        angles = pos[:, None, :, None] * freqs
    else:
        angles = (float(offset) + steps)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, *, offset=0, base: float = 10000.0):
    """Half-split rotary embedding over the last two dims of
    (..., seq, head_dim), in f32, rounded back to x.dtype. ``offset`` is
    the global position of the first row: an int, or a (B,) tensor of
    per-row offsets for a (B, heads, seq, head_dim) input."""
    half = x.shape[-1] // 2
    cos, sin = rope_table(x.shape[-2], x.shape[-1], base=base,
                          offset=offset, device=x.device)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    rotated = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                        dim=-1)
    return rotated.to(x.dtype)

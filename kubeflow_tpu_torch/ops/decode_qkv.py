"""Fused QKV projection + RoPE for the decode step.

The counterpart of ``kubeflow_tpu/ops/decode_qkv.py``: one thin-row
product against the q|k|v weights concatenated along the output axis,
N = (heads + 2 * kv_heads) * head_dim, with the rotary embedding applied
to the first ``rope_heads`` head-columns at each row's own position.

Numerics contract (the reference's, op for op): f32-accumulated dot,
optional int8 per-channel ``scale``, round to ``x.dtype``, rope in f32
on the rounded values (:func:`kubeflow_tpu_torch.ops.attention.apply_rope`'s
half-split formula), round back. The v columns pass through.

On a CUDA tensor :func:`qkv_rope` launches ``csrc/decode_qkv.cu`` or
raises; on a CPU tensor it runs :func:`qkv_rope_reference`.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.gemv import MAX_ROWS


def qkv_rope_fits(rows: int, k: int, n: int, head_dim: int) -> bool:
    """True when the kernel accepts these shapes: thin rows, an even head
    dim that tiles N into whole heads (each lane owns a rotary pair)."""
    return (1 <= rows <= MAX_ROWS and head_dim % 2 == 0 and head_dim > 0
            and n % head_dim == 0 and k > 0)


def rope_rows(y: torch.Tensor, pos: torch.Tensor, head_dim: int,
              base: float = 10000.0) -> torch.Tensor:
    """Half-split rotary embedding over (R, cols) of whole heads at
    per-row positions ``pos`` (R,): upcast to f32, rotate, round back
    to ``y.dtype``."""
    rows, cols = y.shape
    half = head_dim // 2
    f = y.float().reshape(rows, cols // head_dim, head_dim)
    f1, f2 = f[..., :half], f[..., half:]
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=y.device) / half)
    angles = pos.to(torch.float32)[:, None, None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    rotated = torch.cat([f1 * cos - f2 * sin, f2 * cos + f1 * sin], dim=-1)
    return rotated.reshape(rows, cols).to(y.dtype)


def qkv_rope_reference(x, w, pos, scale=None, *, head_dim: int,
                       rope_heads: int, base: float = 10000.0):
    """The plain version of :func:`qkv_rope`."""
    y = x.float() @ w.float()
    if scale is not None:
        y = y * scale.float()
    yd = y.to(x.dtype)
    rope_cols = rope_heads * head_dim
    return torch.cat([rope_rows(yd[:, :rope_cols], pos, head_dim, base),
                      yd[:, rope_cols:]], dim=1)


def qkv_rope(x, w, pos, scale=None, *, head_dim: int, rope_heads: int,
             base: float = 10000.0) -> torch.Tensor:
    """(R, K) @ (K, N) with rope on the leading ``rope_heads`` heads at
    per-row position ``pos`` (R,) int32. Returns (R, N) in x.dtype."""
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"qkv_rope wants 2-D x and w, got {tuple(x.shape)}"
                         f" @ {tuple(w.shape)}")
    rows, k = x.shape
    wk, n = w.shape
    if wk != k:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if rows > MAX_ROWS:
        raise ValueError(f"qkv_rope is a thin-row kernel (rows <= "
                         f"{MAX_ROWS}); got {rows}")
    if tuple(pos.shape) != (rows,):
        raise ValueError(f"pos must be ({rows},), got {tuple(pos.shape)}")
    if not qkv_rope_fits(rows, k, n, head_dim) or rope_heads * head_dim > n:
        raise ValueError(f"qkv_rope does not take N={n} at head_dim "
                         f"{head_dim} with {rope_heads} rope heads")
    if x.device.type == "cpu":
        return qkv_rope_reference(x, w, pos, scale, head_dim=head_dim,
                                  rope_heads=rope_heads, base=base)
    if x.dtype != torch.bfloat16 or w.dtype not in (torch.bfloat16,
                                                    torch.int8):
        raise TypeError(f"qkv_rope kernel takes bf16 x and bf16/int8 w, got "
                        f"{x.dtype} and {w.dtype}")
    pos = pos.to(torch.int32).contiguous()
    if scale is not None:
        scale = scale.to(torch.float32).contiguous()
    _build.require_cuda("qkv_rope", x, w, pos, word_reads=(scale,))
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    lib = _build.library()
    status = lib.kft_qkv_rope(
        _build.ptr(x), _build.ptr(w), _build.ptr(scale), _build.ptr(pos),
        _build.ptr(out), rows, k, n, head_dim, rope_heads * head_dim,
        float(base), int(w.dtype == torch.int8),
        _build.stream_ptr(x.device))
    _build.check(status, "qkv_rope")
    _build.LAUNCHES["qkv_rope"] += 1
    return out

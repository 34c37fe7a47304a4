"""Flash-decode: single-token attention over a KV cache.

The counterpart of ``kubeflow_tpu/ops/decode_attention.py``: q
(B, H, 1, hd) at position ``pos`` (an int, or a (B,) tensor of per-row
positions) against a (B, Hkv, capacity, hd) cache with rows
[0, pos[b]] filled. Masking: col <= pos, and col > pos - window when
``window`` is set. int8 caches pass ``k_scale``/``v_scale``
(B, Hkv, capacity, 1) f32 per-row absmax scales, which fold into the
score and the PV weights. ``rolling=True`` reads the cache as a ring:
slot j holds the newest global position ≡ j (mod capacity) that is
<= pos, and is live iff that position is >= 0.

On a CUDA tensor :func:`decode_attention` launches
``csrc/decode_attention.cu`` or raises; on a CPU tensor it runs
:func:`decode_attention_reference`, the dense masked read.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops import _build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 8


def decode_attention_fits(head_dim: int, group: int) -> bool:
    """True when the kernel was built for this head dim and GQA group."""
    return head_dim in KERNEL_HEAD_DIMS and 1 <= group <= MAX_GROUP


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(-1).expand(b)
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def decode_attention_reference(q, k_cache, v_cache, pos, *, window=None,
                               k_scale=None, v_scale=None, rolling=False):
    """The plain version: one dense masked softmax over the whole
    capacity, the PV weights rounded to q.dtype (the reference's
    compute-dtype PV product)."""
    b, h, _, hd = q.shape
    hkv, capacity = k_cache.shape[1], k_cache.shape[2]
    group = h // hkv
    pos = _pos_vector(pos, b, q.device)
    qg = q.reshape(b, hkv, group, hd).float()
    s = torch.einsum("bkgd,bkld->bkgl", qg, k_cache.float()) * hd ** -0.5
    if k_scale is not None:
        s = s * k_scale[..., 0][:, :, None, :]
    cols = torch.arange(capacity, device=q.device)
    rows = pos[:, None, None, None].long()
    if rolling:
        keep = rows - torch.remainder(rows - cols, capacity) >= 0
    else:
        keep = cols <= rows
        if window is not None:
            keep = keep & (cols > rows - window)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    if v_scale is not None:
        w = w * v_scale[..., 0][:, :, None, :]
    out = torch.einsum("bkgl,bkld->bkgd", w.to(q.dtype).float(),
                       v_cache.float())
    return out.reshape(b, h, 1, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, *, window=None,
                     k_scale=None, v_scale=None, rolling=False):
    """Returns (B, H, 1, hd) in q.dtype; see the module docstring."""
    b, h, t, hd = q.shape
    if t != 1:
        raise ValueError(f"decode_attention takes one token, got t={t}")
    hkv, capacity = k_cache.shape[1], k_cache.shape[2]
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come as a pair")
    if rolling and window is None:
        raise ValueError("rolling caches come from windowed models; "
                         "pass the window")
    if q.device.type == "cpu":
        return decode_attention_reference(
            q, k_cache, v_cache, pos, window=window, k_scale=k_scale,
            v_scale=v_scale, rolling=rolling)
    if not decode_attention_fits(hd, h // hkv):
        raise ValueError(f"decode_attention kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS} and groups <= {MAX_GROUP}; got "
                         f"hd={hd}, group={h // hkv}")
    quantized = k_scale is not None
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    if (q.dtype != torch.bfloat16 or k_cache.dtype != kv_dtype
            or v_cache.dtype != kv_dtype):
        raise TypeError(f"decode_attention kernel takes bf16 q and a "
                        f"{kv_dtype} cache, got {q.dtype}/{k_cache.dtype}")
    pos_vec = _pos_vector(pos, b, q.device).contiguous()
    q = q.contiguous()
    if quantized:
        k_scale = k_scale.to(torch.float32).contiguous()
        v_scale = v_scale.to(torch.float32).contiguous()
    _build.require_cuda("decode_attention", q, k_cache, v_cache, pos_vec,
                        word_reads=(k_scale, v_scale))
    out = torch.empty_like(q)
    lib = _build.library()
    status = lib.kft_decode_attention(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
        _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(pos_vec),
        _build.ptr(out), b, h, hkv, capacity, hd, int(window or 0),
        int(rolling), hd ** -0.5, int(quantized),
        _build.stream_ptr(q.device))
    _build.check(status, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out

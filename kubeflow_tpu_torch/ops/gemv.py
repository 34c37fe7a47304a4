"""Thin-row weight-streaming GEMV for single-token decode.

The counterpart of ``kubeflow_tpu/ops/gemv.py``: (R, K) @ (K, N) -> (R, N)
for R <= ``MAX_ROWS`` activation rows, with the weight streamed once.
``transpose_w=True`` takes the weight as (N, K) and contracts its last
axis (the tied head reading the (vocab, dim) embedding, no transposed
copy). An int8 weight is upcast on the fly and its per-output-channel
``scale`` multiplies after the dot; ``residual`` fuses the projection's
residual add: ``residual + y.to(residual.dtype)``, and the output takes
the residual's dtype (f32 otherwise).

On a CUDA tensor :func:`gemv` launches ``csrc/gemv.cu`` or raises; on
a CPU tensor it runs :func:`gemv_reference`, the plain version beside
it, with the same op order.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops import _build

MAX_ROWS = 8  # beyond this the rows are a real matmul, not a stream


def gemv_fits(rows: int, k: int, n: int) -> bool:
    """True when the kernel accepts these shapes: 1..MAX_ROWS rows, and K
    and N multiples of 16: every lane loads 16 bytes of a weight row (8
    bf16 or 16 int8 elements), along N in the (K, N) layout and along K
    in the (N, K) one."""
    return 1 <= rows <= MAX_ROWS and k % 16 == 0 and n % 16 == 0


def _check(x, w, scale, residual, transpose_w):
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"gemv wants 2-D x and w, got {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    rows, k = x.shape
    n, wk = (w.shape if transpose_w else (w.shape[1], w.shape[0]))
    if wk != k:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} (transpose_w={transpose_w})")
    if rows > MAX_ROWS:
        raise ValueError(f"gemv is a thin-row kernel (rows <= {MAX_ROWS}); "
                         f"got {rows} - use a plain matmul")
    if w.dtype == torch.int8 and residual is not None and scale is None:
        raise ValueError(
            "int8 w with a fused residual needs the per-channel scale "
            "in-kernel (the rescale must precede the residual add)")
    if residual is not None and tuple(residual.shape) != (rows, n):
        raise ValueError(f"residual must be ({rows}, {n}), got "
                         f"{tuple(residual.shape)}")
    if scale is not None and tuple(scale.shape) != (n,):
        raise ValueError(f"scale must be ({n},), got {tuple(scale.shape)}")
    return rows, k, n


def gemv_reference(x, w, scale=None, residual=None, *,
                   transpose_w: bool = False) -> torch.Tensor:
    """The plain version: f32 dot, then ``* scale``, then the residual
    epilogue."""
    wf = w.float()
    y = x.float() @ (wf.t() if transpose_w else wf)
    if scale is not None:
        y = y * scale.float()
    if residual is not None:
        return residual + y.to(residual.dtype)
    return y


def gemv(x, w, scale=None, residual=None, *,
         transpose_w: bool = False) -> torch.Tensor:
    """(R, K) @ (K, N) -> (R, N); see the module docstring."""
    rows, k, n = _check(x, w, scale, residual, transpose_w)
    if x.device.type == "cpu":
        return gemv_reference(x, w, scale, residual, transpose_w=transpose_w)
    if not gemv_fits(rows, k, n):
        raise ValueError(f"gemv kernel does not take rows={rows}, K={k}, "
                         f"N={n} (see gemv_fits)")
    if x.dtype != torch.bfloat16 or w.dtype not in (torch.bfloat16,
                                                    torch.int8):
        raise TypeError(f"gemv kernel takes bf16 x and bf16/int8 w, got "
                        f"{x.dtype} and {w.dtype}")
    if residual is not None and residual.dtype != torch.bfloat16:
        raise TypeError("gemv kernel takes a bf16 residual")
    if scale is not None:
        scale = scale.to(torch.float32).contiguous()
    _build.require_cuda("gemv", x, w, residual, word_reads=(scale,))
    out_dtype = torch.float32 if residual is None else residual.dtype
    out = torch.empty((rows, n), dtype=out_dtype, device=x.device)
    lib = _build.library()
    status = lib.kft_gemv(
        _build.ptr(x), _build.ptr(w), _build.ptr(scale),
        _build.ptr(residual), _build.ptr(out), rows, k, n,
        int(w.dtype == torch.int8), int(transpose_w),
        _build.stream_ptr(x.device))
    _build.check(status, "gemv")
    _build.LAUNCHES["gemv"] += 1
    return out

"""The exact split of an f32 tensor into three bf16 terms.

``hi = bf16(g)``, ``mid = bf16(g - hi)``, ``lo = bf16(g - hi - mid)``:
both differences are exact in f32 and ``lo`` is exact in bf16, so ``hi +
mid + lo == g`` for every f32 value of magnitude 2^-100 to 2^100 (bf16
keeps f32's exponent range; far below it ``lo`` would fall under bf16's
smallest subnormal). A product with an f32 operand then runs on bf16
tensor cores as one product over the three terms with f32 accumulation:
each product of bf16 values is exact in f32, so the result differs from
the f32 product only in the order of its sums. The tied head's backward
takes its f32 logit gradient this way (``models/transformer.py``).

On a CUDA tensor :func:`split3` launches ``csrc/split3.cu`` (one pass:
read the f32, write the three bf16) or raises; on a CPU tensor it runs
:func:`split3_reference`, which gives the same bits.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.ops import _build


def split3_reference(g: torch.Tensor) -> torch.Tensor:
    """(rows, cols) f32 -> (rows, 3 * cols) bf16: each row holds the hi,
    mid and lo terms of ``g``'s row one after another."""
    hi = g.to(torch.bfloat16)
    rest = g - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return torch.cat([hi, mid, lo], dim=1)


def split3(g: torch.Tensor) -> torch.Tensor:
    """:func:`split3_reference`'s result, by the kernel on the card."""
    if g.ndim != 2 or g.dtype != torch.float32:
        raise ValueError(f"split3 takes a 2-D f32 tensor, got "
                         f"{g.dtype} {tuple(g.shape)}")
    if g.device.type == "cpu":
        return split3_reference(g)
    rows, cols = g.shape
    out = torch.empty((rows, 3 * cols), dtype=torch.bfloat16,
                      device=g.device)
    if g.numel() == 0:
        return out
    _build.require_cuda("split3", g, out)
    status = _build.library().kft_split3(
        _build.ptr(g), _build.ptr(out), rows, cols,
        _build.stream_ptr(g.device))
    _build.check(status, "split3")
    _build.LAUNCHES["split3"] += 1
    return out

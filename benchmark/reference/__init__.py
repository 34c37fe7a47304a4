"""Plain PyTorch references of what the benchmark runs, in float32
with TF32 off, written from the models' definitions. They import
nothing of the program and take nothing it made: weights come from
``benchmark.weights`` and inputs from ``benchmark.traffic``.

:class:`Products` is where every product goes: exact f32 for the
reference, or with its operands rounded to fp8 (e4m3 forward, e5m2
backward, one scale a tensor) for the control, the precision below the bf16 the
configurations compute in.
"""

from __future__ import annotations

import contextlib

import torch

# The largest magnitudes of float8 e4m3 (values) and e5m2 (gradients).
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    x = x.float()
    scale = largest / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).float() / scale


class _RoundFP8(torch.autograd.Function):
    """Forward: through e4m3; backward: the gradient through e5m2, as
    fp8 training rounds them (one scale a tensor each way)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 and back to f32, scaled so its largest
    magnitude lands on the format's largest; its gradient through
    e5m2."""
    return _RoundFP8.apply(x)


class Products:
    """``mm``, ``einsum`` and ``conv`` in f32, or on fp8-rounded
    operands (``fp8=True``, the control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def _in(self, x):
        return round_fp8(x) if self.fp8 else x.float()

    def mm(self, a, b):
        return self._in(a) @ self._in(b)

    def einsum(self, spec, a, b):
        return torch.einsum(spec, self._in(a), self._in(b))

    def conv(self, x, w, stride):
        return torch.nn.functional.conv2d(self._in(x), self._in(w),
                                          stride=stride)


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and convolutions, restored after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn

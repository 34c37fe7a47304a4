"""The BatchNorm op (``kubeflow_tpu_torch/ops/batch_norm.py``) on the CPU:
its plain twin against the composition the port ran before the op fused
the ReLU and the residual sum, and how the op refuses what the kernels
do not take.

The composition is kept here as it stood in ``models/resnet.py``: flax's
train-mode BatchNorm as an autograd Function (f32 statistics with the
fast variance, the closed-form backward), its output rounded to x's
dtype, then ``F.relu`` or ``F.relu(residual + y)``, and the running
averages after it. The twin must give its bits: the output, the running
averages and the gradients of x, scale, bias and the residual. The
kernels' side of the same contract is ``tests/test_torch_cuda.py``'s.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.models.resnet import batch_norm
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.batch_norm import (
    EPSILON,
    MOMENTUM,
    batch_norm_train,
)


class _Composition(torch.autograd.Function):
    """The train-mode BatchNorm as the port wrote it before the op, with
    no group: returns (y, mean, var)."""

    @staticmethod
    def forward(ctx, x, scale, bias):
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = (xf * xf).mean(dim=(0, 2, 3))
        raw = mean2 - mean * mean
        var = torch.clamp_min(raw, 0.0)
        rstd = torch.rsqrt(var + EPSILON)
        mul = rstd * scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] + bias[:, None,
                                                                   None]
        ctx.save_for_backward(x, mean, rstd, scale, raw > 0)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, mean, rstd, scale, active = ctx.saved_tensors
        gf = g.float()
        xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
        count = x.numel() // x.shape[1]
        dbias = gf.sum(dim=(0, 2, 3))
        dscale = (gf * xhat).sum(dim=(0, 2, 3))
        centre = dscale * active / count
        dx = (gf - (dbias / count)[:, None, None]
              - xhat * centre[:, None, None]) * (scale * rstd)[:, None, None]
        return dx.to(x.dtype), dscale, dbias


def _composition(x, scale, bias, run_mean, run_var, relu, residual):
    y, mean, var = _Composition.apply(x, scale, bias)
    if residual is not None:
        y = residual + y
    if relu:
        y = F.relu(y)
    with torch.no_grad():
        new_mean = MOMENTUM * run_mean + (1 - MOMENTUM) * mean
        new_var = MOMENTUM * run_var + (1 - MOMENTUM) * var
    return y, new_mean, new_var


def _inputs(shape, dtype, epilogue, constant, seed=0,
            memory_format=torch.channels_last):
    """x (``constant``: channel 0 one value, so its variance is 0 or
    clips to 0), scale, bias, running mean and var, residual and the
    output's gradient."""
    gen = torch.Generator().manual_seed(seed)
    n, c, h, w = shape

    def act(std=1.0, shift=0.0):
        t = torch.randn(shape, generator=gen) * std + shift
        return t.to(dtype).contiguous(memory_format=memory_format)

    x = act(2.0, 0.5)
    if constant:
        x[:, 0] = 1.5
    scale, bias, run_mean = (torch.randn(c, generator=gen) for _ in range(3))
    run_var = torch.rand(c, generator=gen) + 0.5
    residual = act() if epilogue == "residual" else None
    return x, scale, bias, run_mean, run_var, residual, act()


def _run(fn, x, scale, bias, run_mean, run_var, residual, g, relu):
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias, residual)
              if t is not None]
    res = leaves[3] if residual is not None else None
    out, new_mean, new_var = fn(leaves[0], leaves[1], leaves[2], run_mean,
                                run_var, relu, res)
    grads = torch.autograd.grad(out, leaves, g)
    return [out, new_mean, new_var, *grads]


def _twin(x, scale, bias, run_mean, run_var, relu, residual):
    return batch_norm_train(x, scale, bias, run_mean, run_var, relu=relu,
                            residual=residual)


@pytest.mark.parametrize("epilogue", ["none", "relu", "residual"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,constant", [
    ((4, 20, 7, 5), False), ((4, 20, 7, 5), True), ((8, 8, 4, 4), False),
    ((2, 64, 3, 3), True), ((8, 2048, 1, 1), False)],
    ids=["ragged", "ragged_clipped", "c8", "c64_clipped", "c2048_1x1"])
def test_twin_equals_the_composition_bit_for_bit(shape, constant, dtype,
                                                 epilogue):
    """Output, running averages and the gradients of x, scale, bias (and
    the residual) equal the separate ops' bits, in bf16 and f32, for a
    ragged C, and for a channel whose variance is 0 (``constant``)."""
    args = _inputs(shape, dtype, epilogue, constant)
    relu = epilogue != "none"
    got = _run(_twin, *args, relu)
    want = _run(_composition, *args, relu)
    assert len(got) == len(want) == 6 + (epilogue == "residual")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("epilogue", ["relu", "residual"])
def test_twin_on_an_nchw_activation_equals_the_composition(epilogue):
    """An activation laid out NCHW (the twin takes any layout): the
    composition's bits still, and no kernel launch counted."""
    before = dict(_build.LAUNCHES)
    args = _inputs((4, 20, 7, 5), torch.bfloat16, epilogue, False,
                   memory_format=torch.contiguous_format)
    got = _run(_twin, *args, True)
    assert _build.LAUNCHES == before
    for a, b in zip(got, _run(_composition, *args, True)):
        assert torch.equal(a, b)


def test_residual_without_relu_and_a_device_without_kernels_raise():
    """The residual sum is fused only under the ReLU; a tensor on
    neither the CPU nor a card (meta) raises instead of falling back."""
    x, scale, bias, run_mean, run_var, residual, _ = _inputs(
        (2, 8, 3, 3), torch.float32, "residual", False)
    with pytest.raises(ValueError, match="residual"):
        batch_norm_train(x, scale, bias, run_mean, run_var, relu=False,
                         residual=residual)
    meta = [t.to("meta") for t in (x, scale, bias, run_mean, run_var)]
    with pytest.raises(ValueError, match="CUDA"):
        batch_norm_train(*meta, relu=True)


@pytest.mark.parametrize("epilogue", ["none", "relu", "residual"])
def test_eval_mode_norm_keeps_its_epilogue(epilogue):
    """``models.resnet.batch_norm`` in eval mode: the running averages'
    normalisation, then the residual sum and the ReLU as separate ops."""
    x, scale, bias, run_mean, run_var, residual, _ = _inputs(
        (4, 20, 7, 5), torch.bfloat16, epilogue, False)
    relu = epilogue != "none"
    y, new = batch_norm({"scale": scale, "bias": bias},
                        {"mean": run_mean, "var": run_var}, x, False,
                        relu=relu, residual=residual)
    mul = torch.rsqrt(run_var + EPSILON) * scale
    want = ((x.float() - run_mean[:, None, None]) * mul[:, None, None]
            + bias[:, None, None]).to(x.dtype)
    if residual is not None:
        want = residual + want
    assert new is None and torch.equal(y, F.relu(want) if relu else want)

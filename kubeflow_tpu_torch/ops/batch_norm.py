"""flax BatchNorm in train mode, with the ReLU (and the residual sum)
that follows it in a ResNet block.

:func:`batch_norm_train` returns ``relu(bn(x))``, ``relu(bn(x) +
residual)`` or ``bn(x)`` of an (N, C, H, W) activation, and the new
running averages, through :class:`BatchNormTrain`:

- f32 statistics with the fast variance, ``mean2 - mean**2`` clipped
  at 0, and ``rstd = rsqrt(var + eps)``;
- ``y = (x - mean) * (rstd * scale) + bias`` in f32, rounded once to
  x's dtype; the residual sum and the ReLU as the separate ops take
  them (the sum rounded to x's dtype);
- running averages with momentum 0.9 and the biased variance;
- the closed-form backward ``scale * rstd * (g' - mean(g') - xhat *
  mean(g' * xhat))``, ``g'`` the gradient masked where the output is
  not positive, the last term dropped on a channel whose variance was
  clipped to 0; the residual's gradient is ``g'``.

With a process ``group`` (whose ranks hold equal batches) the moments
are the group's: each rank's mean and mean square times 1/n,
all-reduced (at n = 1 exactly the groupless values), and the backward's
mean(g') and mean(g' * xhat) come from the all-reduced sums. The scale
and bias gradients stay this rank's own sums, which the train step
reduces with every other gradient.

On a CUDA tensor the four passes are ``csrc/batch_norm.cu``'s kernels,
over the activation laid out channels-last (a tensor in another layout
is made channels-last first), or a launch raises; on a CPU tensor the
plain twins below run, which hold the closed form as the port first
wrote it. Given the same statistics the kernels' output and dx are the
twins' bits; the statistics and the sums differ from the twins' only in
the order of their sums.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.parallel.collectives import all_reduce

MOMENTUM = 0.9
EPSILON = 1e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _col(v):
    return v[:, None, None]


# ------------------------------------------------------------ plain twins


def moments_reference(x):
    """(2, C) f32: each channel's mean and mean square over (N, H, W)."""
    xf = x.float()
    return torch.stack([xf.mean(dim=(0, 2, 3)),
                        (xf * xf).mean(dim=(0, 2, 3))])


def normalize_reference(x, mean, mul, bias, residual=None, relu=False):
    """``relu?(round(x - mean) * mul + bias) (+ residual))``: the apply
    pass, given its per-channel mean and ``mul = rstd * scale``."""
    y = ((x.float() - _col(mean)) * _col(mul) + _col(bias)).to(x.dtype)
    if residual is not None:
        y = residual + y
    return F.relu(y) if relu else y


def apply_reference(x, moments, scale, bias, residual=None, relu=False):
    """(out, mean, var, rstd) from the (group's) moments."""
    mean, mean2 = moments
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    rstd = torch.rsqrt(var + EPSILON)
    return (normalize_reference(x, mean, rstd * scale, bias, residual, relu),
            mean, var, rstd)


def masked_grad(g, out):
    """The gradient through the ReLU: ``F.relu``'s own backward, g where
    the output is positive, else 0 (in the layout it gives)."""
    return torch.ops.aten.threshold_backward(g, out, 0)


def grad_sums_reference(g, x, mean, rstd):
    """(sum of g, sum of g * xhat) per channel: the bias and scale
    gradients; ``g`` already masked by the ReLU."""
    gf = g.float()
    xhat = (x.float() - _col(mean)) * _col(rstd)
    return gf.sum(dim=(0, 2, 3)), (gf * xhat).sum(dim=(0, 2, 3))


def dx_reference(g, x, mean, var, rstd, scale, sum_g, sum_gx, count):
    """x's gradient in x's dtype from the (group's) sums over ``count``
    values a channel."""
    xhat = (x.float() - _col(mean)) * _col(rstd)
    centre = sum_gx * (var > 0) / count
    dx = (g.float() - _col(sum_g / count) - xhat * _col(centre)) * _col(
        scale * rstd)
    return dx.to(x.dtype)


# ---------------------------------------------------------------- kernels


def _rows(x) -> tuple[int, int]:
    return x.numel() // x.shape[1], x.shape[1]


def channels_last(t):
    return None if t is None else t.contiguous(
        memory_format=torch.channels_last)


def _check(kernel: str, x, acts=(), vecs=(), tables=()) -> int:
    """Raise unless the kernel takes these inputs: ``x`` and ``acts``
    (activations, None allowed) 4-D f32 or bf16 of one shape and dtype,
    channels-last and 16-byte aligned on x's card; ``vecs`` f32 (C,)
    vectors and ``tables`` f32 (k, C) tables there, contiguous. Returns
    x's dtype code. (It makes no views: it runs four times a norm.)"""
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise ValueError(f"{kernel} takes a 4-D f32 or bf16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    device, c = x.device, x.shape[1]
    if device.type != "cuda":
        raise ValueError(f"{kernel}: the kernel takes CUDA tensors, got "
                         f"one on {device}")
    for t in (x, *acts):
        if t is None:
            continue
        if t.dtype != x.dtype or t.shape != x.shape or t.device != device:
            raise ValueError(f"{kernel}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} beside x's {x.dtype} "
                             f"{tuple(x.shape)} on {device}")
        if (not t.is_contiguous(memory_format=torch.channels_last)
                or t.data_ptr() % 16):
            raise ValueError(f"{kernel}: activations must be channels-last "
                             "and 16-byte aligned")
    for dims, group in ((1, vecs), (2, tables)):
        for t in group:
            if (t.dtype != torch.float32 or t.dim() != dims
                    or t.shape[-1] != c or t.device != device
                    or not t.is_contiguous() or t.data_ptr() % 4):
                raise ValueError(
                    f"{kernel}: per-channel values are contiguous f32 of "
                    f"{c} on {device}, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")
    return _DTYPES[x.dtype]


def _stream(x, stream):
    """The caller's stream handle, or x's card's current stream."""
    return _build.stream_ptr(x.device) if stream is None else stream


@functools.lru_cache(maxsize=None)
def _row_blocks(rows: int, c: int, dtype: int) -> int:
    return _build.library().kft_bn_row_blocks(rows, c, dtype)


def _partial(x):
    """Scratch for the row blocks' partial sums: (blocks, 2, C) f32."""
    rows, c = _rows(x)
    blocks = _row_blocks(rows, c, _DTYPES[x.dtype])
    return torch.empty((blocks, 2, c), dtype=torch.float32, device=x.device)


def _f32(c: int, device, rows: int = 0):
    shape = (rows, c) if rows else (c,)
    return torch.empty(shape, dtype=torch.float32, device=device)


def stats(x, n: int = 1, stream=None):
    """(2, C) f32: the channels' sums of x and x * x over (N, H, W) times
    1 / (rows * n), by ``kft_bn_stats``: the mean and mean square, or
    with n ranks one rank's share of the group's."""
    dtype = _check("bn_stats", x)
    rows, c = _rows(x)
    moments, partial = _f32(c, x.device, 2), _partial(x)
    status = _build.library().kft_bn_stats(
        _build.ptr(x), _build.ptr(partial), _build.ptr(moments), rows, c,
        dtype, 1.0 / (rows * n), _stream(x, stream))
    _build.check(status, "bn_stats")
    _build.LAUNCHES["bn_stats"] += 1
    return moments


def apply(x, moments, scale, bias, run_mean, run_var, residual=None,
          relu=False, stream=None):
    """(out, saved (3, C): mean, var, rstd, new running mean, new running
    var) by ``kft_bn_apply``."""
    dtype = _check("bn_apply", x, (residual,),
                   (scale, bias, run_mean, run_var), (moments,))
    rows, c = _rows(x)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    saved, new_mean, new_var = (_f32(c, x.device, 3), _f32(c, x.device),
                                _f32(c, x.device))
    status = _build.library().kft_bn_apply(
        _build.ptr(x), _build.ptr(residual), _build.ptr(out),
        _build.ptr(moments), _build.ptr(scale), _build.ptr(bias),
        _build.ptr(run_mean), _build.ptr(run_var), _build.ptr(saved),
        _build.ptr(new_mean), _build.ptr(new_var), rows, c, dtype,
        int(relu), EPSILON, MOMENTUM, 1 - MOMENTUM,
        _stream(x, stream))
    _build.check(status, "bn_apply")
    _build.LAUNCHES["bn_apply"] += 1
    return out, saved, new_mean, new_var


def grad_sums(g, x, out, saved, stream=None):
    """(dbias, dscale) f32 by ``kft_bn_grad_sums``; ``out`` (the
    forward's ReLU output) masks g, None for no ReLU."""
    dtype = _check("bn_grad_sums", x, (g, out), (), (saved,))
    rows, c = _rows(x)
    partial, dbias, dscale = (_partial(x), _f32(c, x.device),
                              _f32(c, x.device))
    status = _build.library().kft_bn_grad_sums(
        _build.ptr(g), _build.ptr(x), _build.ptr(out), _build.ptr(saved),
        _build.ptr(partial), _build.ptr(dbias), _build.ptr(dscale), rows, c,
        dtype, _stream(x, stream))
    _build.check(status, "bn_grad_sums")
    _build.LAUNCHES["bn_grad_sums"] += 1
    return dbias, dscale


def dx(g, x, out, saved, scale, sum_g, sum_gx, count: int,
       residual_grad: bool = False, stream=None):
    """(dx, the residual's gradient g' or None) by ``kft_bn_dx``; the
    residual's gradient needs ``out`` (the sum sits under the ReLU)."""
    dtype = _check("bn_dx", x, (g, out), (scale, sum_g, sum_gx), (saved,))
    rows, c = _rows(x)
    grad_x = torch.empty_like(x, memory_format=torch.channels_last)
    dres = (torch.empty_like(x, memory_format=torch.channels_last)
            if residual_grad else None)
    status = _build.library().kft_bn_dx(
        _build.ptr(g), _build.ptr(x), _build.ptr(out), _build.ptr(saved),
        _build.ptr(scale), _build.ptr(sum_g), _build.ptr(sum_gx),
        _build.ptr(grad_x), _build.ptr(dres), rows, c, dtype, 1.0 / count,
        _stream(x, stream))
    _build.check(status, "bn_dx")
    _build.LAUNCHES["bn_dx"] += 1
    return grad_x, dres


# --------------------------------------------------------------- autograd


class BatchNormTrain(torch.autograd.Function):
    """(out, new running mean, new running var); only out carries a
    gradient, to x, scale, bias and the residual. Saves x (its own
    dtype), the per-channel mean, var and rstd, the scale, and the
    output where a ReLU masks the gradient (the next layer keeps that
    tensor anyway)."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, run_mean, run_var, group,
                relu):
        if residual is not None and not relu:
            raise ValueError("a residual sum is fused only under the ReLU")
        card = x.device.type != "cpu"
        n = 1 if group is None else group.size()
        if card:
            x, residual = channels_last(x), channels_last(residual)
            _check("bn_stats", x)
            stream = _build.stream_ptr(x.device)
            moments = stats(x, n, stream)
        else:
            moments = moments_reference(x)
            if group is not None:
                moments = moments * (1.0 / n)
        if group is not None:
            moments = all_reduce(moments, group)
        if card:
            out, saved, new_mean, new_var = apply(
                x, moments, scale, bias, run_mean, run_var, residual, relu,
                stream)
        else:
            out, mean, var, rstd = apply_reference(x, moments, scale, bias,
                                                   residual, relu)
            saved = torch.stack([mean, var, rstd])
            new_mean = MOMENTUM * run_mean + (1 - MOMENTUM) * mean
            new_var = MOMENTUM * run_var + (1 - MOMENTUM) * var
        ctx.group, ctx.n, ctx.relu = group, n, relu
        ctx.residual = residual is not None
        ctx.save_for_backward(x, saved, scale, out if relu else None)
        ctx.mark_non_differentiable(new_mean, new_var)
        return out, new_mean, new_var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, saved, scale, out = ctx.saved_tensors
        count = x.numel() // x.shape[1] * ctx.n
        card = x.device.type != "cpu"
        if card:
            g = channels_last(g)
            stream = _build.stream_ptr(x.device)
            dbias, dscale = grad_sums(g, x, out, saved, stream)
        else:
            mean, var, rstd = saved
            if ctx.relu:
                g = masked_grad(g, out)
            dbias, dscale = grad_sums_reference(g, x, mean, rstd)
        sum_g, sum_gx = dbias, dscale
        if ctx.group is not None:
            sum_g, sum_gx = all_reduce(torch.stack([dbias, dscale]),
                                       ctx.group)
        if card:
            dx_, dres = dx(g, x, out, saved, scale, sum_g, sum_gx, count,
                           ctx.residual and ctx.needs_input_grad[3], stream)
        else:
            dx_ = dx_reference(g, x, mean, var, rstd, scale, sum_g, sum_gx,
                               count)
            dres = g if ctx.residual else None
        return dx_, dscale, dbias, dres, None, None, None, None


def batch_norm_train(x, scale, bias, run_mean, run_var, group=None,
                     relu: bool = False, residual=None):
    """``relu?(bn(x) (+ residual))`` in train mode and the new running
    averages: (out, new mean, new var). The residual sum needs the ReLU
    (a ResNet block's last norm)."""
    return BatchNormTrain.apply(x, scale, bias, residual, run_mean, run_var,
                                group, relu)


__all__ = ["BatchNormTrain", "batch_norm_train", "moments_reference",
           "apply_reference", "normalize_reference", "grad_sums_reference",
           "dx_reference", "masked_grad", "MOMENTUM", "EPSILON"]

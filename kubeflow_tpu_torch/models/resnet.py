"""ResNet v1.5: bf16 compute, f32 parameters and batch statistics.

The counterpart of ``kubeflow_tpu/models/resnet.py``. As in flax, the
model holds no weights: ``model(params, batch_stats, images, train)`` is
applied to the reference's variable dicts, in its names and layouts:

- ``conv_init``, ``norm_init``, ``BottleneckBlock_<i>`` (ResNet-50) or
  ``BasicBlock_<i>`` (ResNet-18) numbered across the stages, each with
  ``Conv_<j>``/``BatchNorm_<j>`` and, where the block changes shape,
  ``conv_proj``/``norm_proj``; then ``head``;
- conv ``kernel`` HWIO, head ``kernel`` (in, out) and ``bias``,
  BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
  (``batch_stats``), all f32.

Images come NHWC, as the reference takes them; ``permute`` to NCHW
leaves them channels-last in memory, the layout cuDNN's bf16
convolutions run fastest on, and every activation after stays so. Conv
kernels are permuted to OIHW and cast to the compute dtype at use.

What the reference does that torch's modules do not, and how the port
keeps it:

- ``padding="SAME"`` pads ``total // 2`` before and the rest after:
  2/3 for the 7x7 stride-2 stem on 224, 0/1 for a 3x3 stride-2 conv
  and for the 3x3 stride-2 max pool (which pads with -inf) on an even
  size. ``F.conv2d``/``F.max_pool2d`` pad symmetrically, so the port
  pads with ``F.pad`` wherever the two sides differ.
- flax BatchNorm takes batch statistics in f32 with the fast variance,
  ``E[x^2] - E[x]^2`` clipped at 0, normalises in f32 as
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` and rounds to the
  compute dtype; its running averages use momentum 0.9 and the biased
  variance. ``nn.BatchNorm2d`` updates with the unbiased variance, so
  the port has its own (``ops/batch_norm.py``: the closed-form backward,
  keeping only the bf16 input; kernels on the card), with the ReLU and
  the residual sum after it fused in, and the train-mode call returns
  the new ``batch_stats`` instead of writing them, as
  ``mutable=["batch_stats"]`` does.
- On a mesh the batch is split over (dp, fsdp), and a sharded flax
  BatchNorm under ``jit`` takes the WHOLE batch's moments. The train
  step passes that axes' process ``group``: the forward's per-channel
  mean and mean square and the backward's sums of g and g * xhat are
  all-reduced over it.
- The mean pool sums in f32 and rounds to the compute dtype (``jnp.mean``
  of bf16); the head runs in f32.
- On an fsdp mesh the reference's step holds a whole weight only while
  the op that uses it runs. The port gathers one piece at a time: the
  stem, each residual block and the head run under
  ``parallel.fsdp.gathered_call``, which gathers the piece's fsdp leaves
  for its forward and again in its backward.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.ops.batch_norm import EPSILON, batch_norm_train
from kubeflow_tpu_torch.parallel.fsdp import gathered_call

# The head's truncated normal: variance_scaling(1, "fan_in",
# "truncated_normal") divides the std by the std of a unit normal
# truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """``padding="SAME"`` along one axis: (before, after) so that the
    output has ceil(size / stride) positions, before = total // 2."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel: int, stride: int, value: float = 0.0):
    """(x padded where SAME pads unevenly, the symmetric padding left
    for the op itself)."""
    (top, bottom), (left, right) = (same_pads(x.shape[2], kernel, stride),
                                    same_pads(x.shape[3], kernel, stride))
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


def conv(x, kernel, stride: int, dtype):
    """flax ``nn.Conv(use_bias=False, padding="SAME", dtype=dtype)``: x
    (N, C, H, W) in the compute dtype, ``kernel`` (kh, kw, in, out) f32,
    cast to the dtype and laid out channels-last at use."""
    w = kernel.permute(3, 2, 0, 1).to(dtype=dtype,
                                      memory_format=torch.channels_last)
    x, padding = _pad_same(x, kernel.shape[0], stride)
    return F.conv2d(x, w, stride=stride, padding=padding)


def max_pool(x):
    """``nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")``: the
    padding is -inf."""
    x, padding = _pad_same(x, 3, 2, value=float("-inf"))
    return F.max_pool2d(x, 3, stride=2, padding=padding)


def batch_norm(p, stats, x, train: bool, group=None, relu: bool = False,
               residual=None):
    """One BatchNorm and what follows it: ``relu(bn(x) + residual)``,
    ``relu(bn(x))`` or ``bn(x)``. ``p`` holds ``scale``/``bias``,
    ``stats`` ``mean``/``var``; ``group`` takes the moments over a split
    batch. Train mode runs ``ops.batch_norm.batch_norm_train`` (the
    kernels on the card). Returns (y, new stats or None)."""
    if not train:
        mul = torch.rsqrt(stats["var"] + EPSILON) * p["scale"]
        y = ((x.float() - stats["mean"][:, None, None]) * mul[:, None, None]
             + p["bias"][:, None, None]).to(x.dtype)
        if residual is not None:
            y = residual + y
        return (F.relu(y) if relu else y), None
    y, mean, var = batch_norm_train(x, p["scale"], p["bias"], stats["mean"],
                                    stats["var"], group, relu, residual)
    return y, {"mean": mean, "var": var}


class BottleneckBlock:
    """1x1 -> 3x3 -> 1x1 bottleneck (ResNet-50), projection shortcut on a
    shape change."""

    @staticmethod
    def convs(cin: int, filters: int, stride: int):
        """(kernel size, in, out, stride) of ``Conv_0``, ``Conv_1``, ..."""
        return [(1, cin, filters, 1), (3, filters, filters, stride),
                (1, filters, filters * 4, 1)]


class BasicBlock:
    """3x3 -> 3x3 residual block (ResNet-18/34)."""

    @staticmethod
    def convs(cin: int, filters: int, stride: int):
        return [(3, cin, filters, stride), (3, filters, filters, 1)]


def _block(convs, stride, p, norm, x, dtype):
    """One residual block, as both reference blocks run it: conv ->
    norm -> relu for each conv but the last, whose norm (zero-initialised
    scale) feeds the residual sum and the relu after it;
    ``conv_proj``/``norm_proj`` (at the block's stride, no relu) on the
    shortcut where the shape changes. ``norm(name, y, relu, residual)``
    is the block's BatchNorm with what follows it."""
    y = x
    for j, (_, _, _, conv_stride) in enumerate(convs[:-1]):
        y = norm(f"BatchNorm_{j}", conv(y, p[f"Conv_{j}"]["kernel"],
                                        conv_stride, dtype), relu=True)
    residual = x
    if "conv_proj" in p:
        residual = norm("norm_proj", conv(x, p["conv_proj"]["kernel"],
                                          stride, dtype))
    last = len(convs) - 1
    return norm(f"BatchNorm_{last}",
                conv(y, p[f"Conv_{last}"]["kernel"], convs[-1][3], dtype),
                relu=True, residual=residual)


def _norms(p, stats, new, train, group=None):
    """The BatchNorms of one scope: ``norm(name, y)`` normalises with
    ``p[name]`` and ``stats[name]`` and keeps the new statistics in
    ``new`` (train mode)."""
    def norm(name, y, relu=False, residual=None):
        y, updated = batch_norm(p[name], stats[name], y, train, group, relu,
                                residual)
        if updated is not None:
            new[name] = updated
        return y
    return norm


class ResNet:
    """ResNet v1.5 over the reference's variables: ``model(params,
    batch_stats, images, train=True)`` takes (N, H, W, C) images and
    returns (logits (N, classes) f32, new batch_stats) in train mode, the
    logits alone in eval mode (running averages)."""

    def __init__(self, stage_sizes, block_cls, num_classes: int = 1000,
                 width: int = 64, dtype=torch.bfloat16):
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls = block_cls
        self.num_classes = num_classes
        self.width = width
        self.dtype = dtype

    def blocks(self):
        """(name, conv specs, stride) of every block, in the reference's
        order and numbering."""
        index, cin = 0, self.width
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                convs = self.block_cls.convs(cin, self.width * 2 ** i, stride)
                yield f"{self.block_cls.__name__}_{index}", convs, stride
                index, cin = index + 1, convs[-1][2]

    def __call__(self, params: dict[str, Any], batch_stats: dict[str, Any],
                 images, train: bool = True, group=None, mesh=None,
                 placements: dict | None = None):
        """``group`` takes the BatchNorm moments over a split batch;
        ``mesh`` and ``placements`` (every leaf's placement by ``flatten``
        path) say which leaves ``params`` holds as fsdp shards: the stem,
        each block and the head gather theirs in turn
        (``parallel.fsdp.gathered_call``)."""
        dtype = self.dtype
        new_stats: dict[str, Any] = {}

        def stem(w, x):
            x = _norms(w, batch_stats, new_stats, train, group)(
                "norm_init", conv(x, w["conv_init"]["kernel"], 2, dtype),
                relu=True)
            return max_pool(x)

        def block(w, x, name, convs, stride):
            norm = _norms(w, batch_stats[name], new_stats.setdefault(name, {}),
                          train, group)
            return _block(convs, stride, w, norm, x, dtype)

        def head(w, x):
            return x.float() @ w["head"]["kernel"] + w["head"]["bias"]

        def run(fn, shards, prefix=""):
            return gathered_call(mesh, fn, shards, placements, prefix, dtype)

        x = images.to(dtype).permute(0, 3, 1, 2)   # NHWC memory, NCHW view
        x = run(functools.partial(stem, x=x),
                {k: params[k] for k in ("conv_init", "norm_init")})
        for name, convs, stride in self.blocks():
            x = run(functools.partial(block, x=x, name=name, convs=convs,
                                      stride=stride), params[name], name)
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(dtype)
        logits = run(functools.partial(head, x=x), {"head": params["head"]})
        return (logits, new_stats) if train else logits

    def init_variables(self, seed: int = 0, in_channels: int = 3,
                       device=None) -> dict[str, Any]:
        """Seeded ``{"params", "batch_stats"}`` in the reference's names
        and layouts: conv kernels ~ N(0, 2 / fan_out) (fan_out = kh * kw
        * out), the head kernel a truncated normal of variance 1 / fan_in
        and a zero bias, BatchNorm scales 1 (0 for the last norm of each
        block's residual branch) and biases 0, running means 0 and
        variances 1. Drawn on the CPU from one ``torch.Generator``, then
        moved to ``device`` (the card unless ``"cpu"``)."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))

        def kernel(k, cin, cout):
            std = math.sqrt(2.0 / (k * k * cout))
            return torch.randn((k, k, cin, cout), generator=gen) * std

        def norm(c, zero=False):
            fill = torch.zeros if zero else torch.ones
            return ({"scale": fill(c), "bias": torch.zeros(c)},
                    {"mean": torch.zeros(c), "var": torch.ones(c)})

        params: dict[str, Any] = {"conv_init": {
            "kernel": kernel(7, in_channels, self.width)}}
        stats: dict[str, Any] = {}
        params["norm_init"], stats["norm_init"] = norm(self.width)
        cin = self.width
        for name, convs, stride in self.blocks():
            p, s = {}, {}
            for j, (k, c_in, c_out, _) in enumerate(convs):
                p[f"Conv_{j}"] = {"kernel": kernel(k, c_in, c_out)}
                p[f"BatchNorm_{j}"], s[f"BatchNorm_{j}"] = norm(
                    c_out, zero=j == len(convs) - 1)
            cout = convs[-1][2]
            if cin != cout or stride != 1:
                p["conv_proj"] = {"kernel": kernel(1, cin, cout)}
                p["norm_proj"], s["norm_proj"] = norm(cout)
            params[name], stats[name] = p, s
            cin = cout
        std = math.sqrt(1.0 / cin) / _TRUNC_STD
        head = torch.empty(cin, self.num_classes)
        torch.nn.init.trunc_normal_(head, std=std, a=-2 * std, b=2 * std,
                                    generator=gen)
        params["head"] = {"kernel": head,
                          "bias": torch.zeros(self.num_classes)}

        def move(tree):
            return {k: move(v) if isinstance(v, dict)
                    else v.to(device=dev, dtype=torch.float32)
                    for k, v in tree.items()}

        return {"params": move(params), "batch_stats": move(stats)}


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], BottleneckBlock, num_classes=num_classes,
                  **kw)


def resnet18(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes=num_classes, **kw)


def resnet_flops_per_image(model: str = "resnet50",
                           image_size: int = 224) -> float:
    """Approximate forward-pass FLOPs per image (MACs x 2), for MFU."""
    base = {"resnet50": 4.09e9, "resnet18": 1.81e9}[model]
    return base * 2 * (image_size / 224) ** 2


__all__ = ["ResNet", "BottleneckBlock", "BasicBlock", "resnet50", "resnet18",
           "resnet_flops_per_image", "same_pads", "conv", "max_pool",
           "batch_norm"]

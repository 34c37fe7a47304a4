"""ResNet v1.5 in plain PyTorch, float32 (He et al. 2016, the stride on
the 3x3 of each bottleneck, as MLPerf's reference and torchvision's
``resnet50``), over the leaves ``benchmark.weights.resnet`` makes.

Convolutions pad "SAME" (``total // 2`` before, the rest after); the
stem's max pool pads with -inf. BatchNorm in train mode normalises by
the batch's mean and biased variance (eps 1e-5) and moves the running
averages with momentum 0.9. With a process ``group`` each rank holds a
block of the batch's rows: the mean and the variance are the whole
batch's (sums over the group, through a sum whose backward is the
group's sum too), and the gradients are the whole batch's mean. The head is a dense layer on the spatial
mean. The loss is cross entropy with label smoothing; the optimizer
optax's ``chain(add_decayed_weights(wd, mask=ndim > 1), sgd(lr,
momentum, nesterov=True))``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from benchmark.reference import Products

EPS = 1e-5
MOMENTUM = 0.9
# The std of a unit normal truncated to [-2, 2]: the head's variance
# scaling divides by it.
TRUNC_STD = 0.87962566103423978


def blocks(cfg: dict):
    """(name, [(kernel, in, out, stride) of each conv], stride, in) of
    every bottleneck block."""
    index, cin, width = 0, cfg["width"], cfg["width"]
    for i, count in enumerate(cfg["stage_sizes"]):
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            f = width * 2 ** i
            convs = [(1, cin, f, 1), (3, f, f, stride), (1, f, 4 * f, 1)]
            yield f"BottleneckBlock_{index}", convs, stride, cin
            index, cin = index + 1, 4 * f


def _has_proj(convs, stride, cin) -> bool:
    return cin != convs[-1][2] or stride != 1


def conv_specs(cfg: dict):
    """(scope, kernel, in, out) of every convolution."""
    yield "conv_init", 7, cfg["channels"], cfg["width"]
    for name, convs, stride, cin in blocks(cfg):
        for j, (k, c_in, c_out, _) in enumerate(convs):
            yield f"{name}/Conv_{j}", k, c_in, c_out
        if _has_proj(convs, stride, cin):
            yield f"{name}/conv_proj", 1, cin, convs[-1][2]


def norm_specs(cfg: dict):
    """(scope, channels, scale starts at zero) of every BatchNorm."""
    yield "norm_init", cfg["width"], False
    for name, convs, stride, cin in blocks(cfg):
        for j, (_, _, c_out, _) in enumerate(convs):
            yield f"{name}/BatchNorm_{j}", c_out, j == len(convs) - 1
        if _has_proj(convs, stride, cin):
            yield f"{name}/norm_proj", convs[-1][2], False


def head_shape(cfg: dict) -> tuple[int, int]:
    last = list(blocks(cfg))[-1][1][-1][2]
    return last, cfg["classes"]


def _same(size: int, kernel: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad(x, kernel: int, stride: int, value: float = 0.0):
    top, bottom = _same(x.shape[2], kernel, stride)
    left, right = _same(x.shape[3], kernel, stride)
    return F.pad(x, (left, right, top, bottom), value=value)


class _GroupSum(torch.autograd.Function):
    """A sum over the ranks of ``group``; its gradient, the sum of the
    ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _batch_mean(x, group):
    """The mean over (N, H, W) of the whole batch."""
    if group is None:
        return x.mean(dim=(0, 2, 3))
    count = x.numel() // x.shape[1] * dist.get_world_size(group)
    return _GroupSum.apply(x.sum(dim=(0, 2, 3)), group) / count


def forward(p: dict, stats: dict, images, cfg: dict,
            prod: Products | None = None, group=None):
    """(N, H, W, C) images -> (f32 logits, new running statistics)."""
    prod = prod or Products()
    new = {}

    def conv(x, scope, stride):
        w = p[f"{scope}/kernel"].permute(3, 2, 0, 1)
        return prod.conv(_pad(x, w.shape[-1], stride), w, stride)

    def norm(x, scope):
        mean = _batch_mean(x, group)
        var = _batch_mean((x - mean[:, None, None]) ** 2, group)
        with torch.no_grad():
            new[f"{scope}/mean"] = (MOMENTUM * stats[f"{scope}/mean"]
                                    + (1 - MOMENTUM) * mean)
            new[f"{scope}/var"] = (MOMENTUM * stats[f"{scope}/var"]
                                   + (1 - MOMENTUM) * var)
        mul = torch.rsqrt(var + EPS) * p[f"{scope}/scale"]
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + p[f"{scope}/bias"][:, None, None])

    x = images.float().permute(0, 3, 1, 2)
    x = F.relu(norm(conv(x, "conv_init", 2), "norm_init"))
    x = F.max_pool2d(_pad(x, 3, 2, float("-inf")), 3, stride=2)
    for name, convs, stride, cin in blocks(cfg):
        y = x
        for j, (_, _, _, s) in enumerate(convs):
            y = norm(conv(y, f"{name}/Conv_{j}", s), f"{name}/BatchNorm_{j}")
            if j < len(convs) - 1:
                y = F.relu(y)
        residual = x
        if _has_proj(convs, stride, cin):
            residual = norm(conv(x, f"{name}/conv_proj", stride),
                            f"{name}/norm_proj")
        x = F.relu(residual + y)
    x = x.mean(dim=(2, 3))
    return prod.mm(x, p["head/kernel"]) + p["head/bias"], new


class NesterovSGD:
    """optax: weight decay on leaves of more than one dimension, then
    SGD with Nesterov momentum."""

    def __init__(self, opt: dict, params: dict):
        self.opt = opt
        self.trace = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        o = self.opt
        for k, p in params.items():
            u = grads[k]
            if p.ndim > 1:
                u = u + o["weight_decay"] * p
            self.trace[k] = u + o["momentum"] * self.trace[k]
            p.sub_(o["lr"] * (u + o["momentum"] * self.trace[k]))


def train(p: dict, stats: dict, cfg: dict, batches, opt: dict,
          prod: Products | None = None, group=None):
    """Steps of the smoothed loss from the f32 leaves ``p`` (updated in
    place); with a ``group``, of this rank's rows of each batch. Returns
    (losses, the first step's gradients)."""
    prod = prod or Products()
    sgd = NesterovSGD(opt, p)
    losses, first = [], None
    ranks = 1 if group is None else dist.get_world_size(group)
    for images, labels in batches:
        for leaf in p.values():
            leaf.requires_grad_(True)
        logits, stats = forward(p, stats, images, cfg, prod, group)
        loss = F.cross_entropy(logits, labels,
                               label_smoothing=cfg["label_smoothing"])
        got = torch.autograd.grad(loss, list(p.values()))
        for leaf in p.values():
            leaf.requires_grad_(False)
        loss = loss.detach()
        if group is not None:
            # Every rank's gradient reaches the whole batch's moments
            # through _GroupSum: their sum over the ranks is that of the
            # ranks' losses, and the mean loss's is its share.
            flat = torch.cat([loss.reshape(1)]
                             + [g.reshape(-1) for g in got]) / ranks
            dist.all_reduce(flat, group=group)
            parts = flat.split([1] + [g.numel() for g in got])
            loss = parts[0][0]
            got = [part.view(g.shape) for part, g in zip(parts[1:], got)]
        grads = dict(zip(p, got))
        losses.append(float(loss))
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        sgd.step(p, grads)
        del logits, loss, got
    return losses, first

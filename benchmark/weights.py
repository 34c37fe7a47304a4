"""Weights from the run's seed, made on the device in a few large draws.

The benchmark makes the weights once for the program and again, from
the same seed, for the plain reference, which so takes nothing the
program made. Leaves are a flat dict keyed by ``/``-joined paths in the
layout the program's models take (:func:`nest` builds their trees).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import resnet as resnet_ref


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 64 - 1))
    return gen


def lm_leaves(cfg: dict):
    """(path, shape, std) of every LM leaf in draw order; std None is a
    norm scale of ones. Kernels ~ N(0, 1 / fan_in), the tied embedding
    ~ N(0, 1 / dim)."""
    d, kv = cfg["dim"], cfg["kv_heads"] * cfg["head_dim"]
    hidden = cfg["mlp_ratio"] * d
    yield "embed/embedding", (cfg["vocab"], d), d ** -0.5
    for i in range(cfg["layers"]):
        blk = f"block_{i}"
        yield f"{blk}/RMSNorm_0/scale", (d,), None
        yield f"{blk}/q_proj/kernel", (d, d), d ** -0.5
        yield f"{blk}/k_proj/kernel", (d, kv), d ** -0.5
        yield f"{blk}/v_proj/kernel", (d, kv), d ** -0.5
        yield f"{blk}/proj/kernel", (d, d), d ** -0.5
        yield f"{blk}/RMSNorm_1/scale", (d,), None
        yield f"{blk}/up/kernel", (d, hidden), d ** -0.5
        yield f"{blk}/down/kernel", (hidden, d), hidden ** -0.5
    yield "final_norm/scale", (d,), None


def _draw(leaves, seed: int, device, dtype) -> dict:
    """One normal draw for every random leaf, split and scaled; norm
    scales (std None) are f32 ones."""
    leaves = list(leaves)
    total = sum(math.prod(shape) for _, shape, std in leaves
                if std is not None)
    flat = torch.randn(total, generator=generator(seed, device),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for path, shape, std in leaves:
        if std is None:
            out[path] = torch.ones(shape, device=device, dtype=torch.float32)
            continue
        n = math.prod(shape)
        out[path] = (flat[at:at + n].view(shape) * std).to(dtype)
        at += n
    return out


def lm(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The LM's leaves: kernels and embedding in ``dtype``."""
    return _draw(lm_leaves(cfg), seed, device, dtype)


def resnet(cfg: dict, seed: int, device) -> tuple[dict, dict]:
    """(params, batch_stats) of the ResNet, f32: conv kernels (HWIO) ~
    N(0, 2 / (k * k * out)) in one draw, the head a normal truncated at
    two deviations of variance 1 / fan_in (a second draw) and a zero
    bias; BatchNorm scales 1 (0 for the last norm of each residual
    branch), biases 0, running means 0 and variances 1."""
    convs = list(resnet_ref.conv_specs(cfg))
    leaves = [(f"{scope}/kernel", (k, k, cin, cout),
               math.sqrt(2.0 / (k * k * cout)))
              for scope, k, cin, cout in convs]
    params = _draw(leaves, seed, device, torch.float32)
    stats = {}
    for scope, channels, zero in resnet_ref.norm_specs(cfg):
        fill = torch.zeros if zero else torch.ones
        params[f"{scope}/scale"] = fill(channels, device=device)
        params[f"{scope}/bias"] = torch.zeros(channels, device=device)
        stats[f"{scope}/mean"] = torch.zeros(channels, device=device)
        stats[f"{scope}/var"] = torch.ones(channels, device=device)
    features, classes = resnet_ref.head_shape(cfg)
    std = math.sqrt(1.0 / features) / resnet_ref.TRUNC_STD
    head = torch.empty(features, classes, device=device)
    torch.nn.init.trunc_normal_(head, std=std, a=-2 * std, b=2 * std,
                                generator=generator(seed + 1, device))
    params["head/kernel"] = head
    params["head/bias"] = torch.zeros(classes, device=device)
    return params, stats


def nest(flat: dict) -> dict:
    """``{"a/b/c": t}`` -> ``{"a": {"b": {"c": t}}}``."""
    tree: dict = {}
    for path, leaf in flat.items():
        *groups, name = path.split("/")
        node = tree
        for key in groups:
            node = node.setdefault(key, {})
        node[name] = leaf
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    """The inverse of :func:`nest`."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten(value, path + "/"))
        else:
            out[path] = value
    return out

"""The port's optimizers, as plain functions on tensors: AdamW with a
low-precision first moment (the LM's) and Nesterov SGD with masked
weight decay (ResNet's, :func:`make_optimizer`).

AdamW is the counterpart of ``optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8,
weight_decay, mu_dtype=bfloat16)``, the reference LM's optimizer
(``kubeflow_tpu/models/transformer.py`` ``create_lm_state``).
``torch.optim.AdamW`` keeps its moments in the parameters' dtype, so the
port carries optax's own order of operations instead:

1. mu and nu are updated in f32: ``(1 - b1) * g + b1 * mu`` and
   ``(1 - b2) * g**2 + b2 * nu``. With a bf16 mu, ``b1 * mu`` is a bf16
   product with b1 rounded to bf16 (JAX's weak-typed scalar), summed in
   f32;
2. the bias-corrected update ``mu_hat / (sqrt(nu_hat) + eps)`` uses that
   f32 mu, with ``1 - b**count`` in f32;
3. only the stored mu is cast to ``mu_dtype``;
4. then ``+ weight_decay * param`` on every leaf (the reference passes no
   mask), then ``* -lr``, added to the parameter.

Parameters and moments are nested dicts of tensors in the reference
layout, gradients a sequence in :func:`flatten` order; ``update`` works
in place (the reference donates its state) and must run under
``torch.no_grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def flatten(tree: dict[str, Any], prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, keys sorted at every level,
    so trees of one structure flatten in one order."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.extend(flatten(value, path))
        else:
            out.append((path, value))
    return out


def tree_map(fn, tree: dict[str, Any]) -> dict[str, Any]:
    return {key: tree_map(fn, value) if isinstance(value, dict) else fn(value)
            for key, value in tree.items()}


def tree_map_with_path(fn, tree: dict[str, Any],
                       prefix: str = "") -> dict[str, Any]:
    """``fn(path, leaf)`` over a nested dict, the paths as
    :func:`flatten` writes them."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out[key] = (tree_map_with_path(fn, value, path)
                    if isinstance(value, dict) else fn(path, value))
    return out


def map_param_trees(node, fn):
    """``fn`` over every parameter-shaped dict of an optimizer state
    (AdamW's mu and nu, the SGD chain's trace), its structure kept."""
    if isinstance(node, dict):
        return fn(node)
    if isinstance(node, (list, tuple)):
        return type(node)(map_param_trees(child, fn) for child in node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{
            f.name: map_param_trees(getattr(node, f.name), fn)
            for f in dataclasses.fields(node)})
    return node


def trainable(params: dict[str, Any]) -> dict[str, Any]:
    """The same nested dict with every leaf a tensor that requires grad
    (the leaves themselves, flagged in place)."""
    return {key: trainable(value) if isinstance(value, dict)
            else value.requires_grad_(True)
            for key, value in params.items()}


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState``: the update count and the two
    moments, each a tree shaped like the parameters."""

    count: int
    mu: dict[str, Any]
    nu: dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw``'s arguments and defaults (no mask, no Nesterov)."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    mu_dtype: torch.dtype | None = None

    def init(self, params: dict[str, Any]) -> AdamWState:
        def zeros(p, dtype=None):
            return torch.zeros_like(p, dtype=dtype, requires_grad=False)

        return AdamWState(
            count=0, mu=tree_map(lambda p: zeros(p, self.mu_dtype), params),
            nu=tree_map(zeros, params))

    def update(self, grads, state: AdamWState,
               params: dict[str, Any]) -> None:
        """One step, in place on ``params`` and ``state``; ``grads`` is a
        sequence in ``flatten(params)`` order (what ``torch.autograd.grad``
        returns for those leaves)."""
        flat_p = flatten(params)
        flat_mu, flat_nu = flatten(state.mu), flatten(state.nu)
        paths = [path for path, _ in flat_p]
        if (len(grads) != len(paths)
                or [path for path, _ in flat_mu] != paths
                or [path for path, _ in flat_nu] != paths):
            raise ValueError("grads and optimizer state must match the "
                             "parameter tree")
        count = state.count + 1
        device = flat_p[0][1].device
        one = torch.ones((), dtype=torch.float32, device=device)
        b1_pow = torch.full((), self.b1, dtype=torch.float32,
                            device=device) ** count
        b2_pow = torch.full((), self.b2, dtype=torch.float32,
                            device=device) ** count
        bc1, bc2 = one - b1_pow, one - b2_pow
        for (_, p), g, (_, mu), (_, nu) in zip(flat_p, grads, flat_mu,
                                               flat_nu):
            g = g.float()
            # b1 * mu in mu's own dtype, b1 rounded to it first.
            b1 = torch.full((), self.b1, dtype=mu.dtype, device=device)
            mu32 = (1 - self.b1) * g + b1 * mu
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu32 / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(-self.lr * u)
            mu.copy_(mu32)
        state.count = count


# ---------------------------------------------------------------------------
# Nesterov SGD with masked weight decay (the ResNet optimizer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EmptyState:
    """optax's ``EmptyState``: a transformation without state."""


@dataclasses.dataclass
class MaskedState:
    """optax's ``MaskedState``: the state of the masked inner
    transformation."""

    inner_state: Any


@dataclasses.dataclass
class TraceState:
    """optax's ``TraceState``: the momentum trace, shaped like the
    parameters."""

    trace: dict[str, Any]


@dataclasses.dataclass(frozen=True)
class NesterovSGD:
    """The reference's ``make_optimizer``: ``optax.chain(
    add_decayed_weights(weight_decay, mask=ndim > 1), sgd(lr, momentum,
    nesterov=True))``. Its state keeps optax's tree, ``(MaskedState(
    EmptyState()), (TraceState(trace), EmptyState()))``, so the
    checkpoint writes it under the reference's keys."""

    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4

    def init(self, params: dict[str, Any]) -> tuple:
        trace = tree_map(
            lambda p: torch.zeros_like(p, requires_grad=False), params)
        return (MaskedState(EmptyState()), (TraceState(trace), EmptyState()))

    def update(self, grads, state: tuple, params: dict[str, Any]) -> None:
        """One step, in place on ``params`` and the trace, in optax's
        order: ``u = g + wd * p`` (leaves of ndim > 1 only), ``t = u +
        momentum * t``, ``u = u + momentum * t``, ``p = p + (-lr) * u``.
        ``grads`` is a sequence in ``flatten(params)`` order."""
        flat_p = flatten(params)
        flat_t = flatten(state[1][0].trace)
        if (len(grads) != len(flat_p)
                or [path for path, _ in flat_t] != [p for p, _ in flat_p]):
            raise ValueError("grads and optimizer state must match the "
                             "parameter tree")
        for (_, p), g, (_, t) in zip(flat_p, grads, flat_t):
            u = g + self.weight_decay * p if p.ndim > 1 else g
            t.copy_(u + self.momentum * t)
            u = u + self.momentum * t
            p.add_(-self.lr * u)


def make_optimizer(lr: float = 0.1, momentum: float = 0.9,
                   weight_decay: float = 1e-4) -> NesterovSGD:
    """SGD with Nesterov momentum and decoupled weight decay on the
    parameters of ndim > 1 (no decay on BatchNorm scales and biases)."""
    return NesterovSGD(lr, momentum, weight_decay)

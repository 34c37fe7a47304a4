"""Carry flax parameters across to the port.

The reference's params pytree, as nested dicts of numpy arrays (the
caller does ``jax.tree.map(np.asarray, params)``; this module never sees
a JAX object), becomes the same nested dict of torch tensors on the
port's device; :func:`train_state_from_jax` carries a whole train
state across the same way: the LM's (step, f32 params, AdamW moments)
or ResNet's (step, f32 params, ``batch_stats``, the SGD trace), and
:func:`resnet_variables_from_jax` ResNet's ``{"params",
"batch_stats"}`` (HWIO conv kernels, which the port convolves with at
use). Names and
layouts stay as they are: a Dense ``kernel`` stays (in, out), which is
what the GEMV and the fused QKV kernel contract, and the embedding
stays (vocab, dim), which is what the tied head reads with
``transpose_w``. Matmul weights are cast to the compute
dtype once here (the reference casts on every call, to the same
values); norm scales stay f32.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models.optim import (
    AdamW,
    AdamWState,
    EmptyState,
    MaskedState,
    TraceState,
    make_optimizer,
    trainable,
)
from kubeflow_tpu_torch.models.resnet import ResNet
from kubeflow_tpu_torch.models.train import TrainState
from kubeflow_tpu_torch.models.transformer import LMConfig, build_lm

_F32_LEAVES = ("RMSNorm_0", "RMSNorm_1", "final_norm")
# Optimizer moments keep their dtype across (the reference's mu is bf16).
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tensor(array, device, dtype) -> torch.Tensor:
    arr = np.asarray(array)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: widen exactly first
        arr = arr.astype(np.float32)
    # np.array copies: the caller's arrays may be read-only views.
    return torch.from_numpy(np.array(arr, order="C")).to(device=device,
                                                         dtype=dtype)


def params_from_jax(cfg: LMConfig, params_np: dict[str, Any], device=None,
                    dtype=None) -> dict[str, Any]:
    """Flax LM params (numpy leaves) -> the port's parameter dict on
    ``device`` (the card unless ``"cpu"`` is asked for), matmul weights
    in ``dtype`` (default ``cfg.dtype``)."""
    dev = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    out: dict[str, Any] = {}
    for key, sub in params_np.items():
        if key == "embed":
            out[key] = {"embedding": _tensor(sub["embedding"], dev, dtype)}
        elif key == "final_norm":
            out[key] = {"scale": _tensor(sub["scale"], dev, torch.float32)}
        elif key.startswith("block_"):
            if "moe" in sub:
                raise NotImplementedError(
                    "MoE blocks belong to a later slice of the port")
            blk = {}
            for name, leaf in sub.items():
                (leaf_name, value), = leaf.items()
                leaf_dtype = torch.float32 if name in _F32_LEAVES else dtype
                blk[name] = {leaf_name: _tensor(value, dev, leaf_dtype)}
            out[key] = blk
        else:
            raise ValueError(f"unexpected parameter group {key!r}")
    missing = [f"block_{i}" for i in range(cfg.layers)
               if f"block_{i}" not in out]
    if missing or "embed" not in out or "final_norm" not in out:
        raise ValueError(f"params do not match the config: missing "
                         f"{missing or ['embed/final_norm']}")
    return out


def _tree(tree, dev):
    """A nested mapping of numpy arrays as tensors of their own dtype."""
    return {key: _tree(value, dev) if isinstance(value, Mapping)
            else _tensor(value, dev, _DTYPES[np.asarray(value).dtype.name])
            for key, value in tree.items()}


def resnet_variables_from_jax(variables_np, device=None) -> dict[str, Any]:
    """flax ResNet variables (``{"params", "batch_stats"}``, numpy
    leaves) as the port's, f32 tensors in the same names and layouts on
    ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    return {"params": _tree(variables_np["params"], dev),
            "batch_stats": _tree(variables_np.get("batch_stats", {}), dev)}


def train_state_from_jax(cfg, state_np, apply_fn=None, tx=None,
                         device=None) -> TrainState:
    """The reference's TrainState, its leaves numpy arrays (the caller
    does ``jax.tree.map(np.asarray, state)``), as the port's, so that both
    sides continue from the same state.

    With an :class:`LMConfig`: the step, f32 parameters that require
    grad, and the AdamW state (count, mu in its own dtype, bf16 in the
    reference, f32 nu); ``state_np.opt_state`` is optax.adamw's chain
    state, whose first entry holds count/mu/nu. ``apply_fn`` defaults to
    ``build_lm(cfg)``, ``tx`` to the reference's ``AdamW(3e-4,
    weight_decay=0.01, mu_dtype=bf16)``.

    With a :class:`ResNet` model as ``cfg``: the step, the parameters,
    ``batch_stats`` and the SGD chain state's momentum trace
    (``opt_state[1][0].trace``); ``apply_fn`` defaults to the model,
    ``tx`` to ``make_optimizer()``."""
    dev = resolve_device(device)
    if isinstance(cfg, ResNet):
        variables = resnet_variables_from_jax(
            {"params": state_np.params, "batch_stats": state_np.batch_stats},
            device=dev)
        opt_state = (MaskedState(EmptyState()),
                     (TraceState(_tree(state_np.opt_state[1][0].trace, dev)),
                      EmptyState()))
        return TrainState(step=int(state_np.step),
                          params=trainable(variables["params"]),
                          opt_state=opt_state, tx=tx or make_optimizer(),
                          apply_fn=apply_fn or cfg,
                          batch_stats=variables["batch_stats"])
    params = trainable(params_from_jax(cfg, state_np.params, device=dev,
                                       dtype=torch.float32))
    adam = state_np.opt_state[0]
    opt_state = AdamWState(count=int(adam.count), mu=_tree(adam.mu, dev),
                           nu=_tree(adam.nu, dev))
    tx = tx or AdamW(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
    return TrainState(step=int(state_np.step), params=params,
                      opt_state=opt_state, tx=tx,
                      apply_fn=apply_fn or build_lm(cfg))

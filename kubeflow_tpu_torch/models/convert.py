"""Carry flax parameters across to the port.

The reference's params pytree, as nested dicts of numpy arrays (the
caller does ``jax.tree.map(np.asarray, params)``; this module never sees
a JAX object), becomes the same nested dict of torch tensors on the
port's device; :func:`train_state_from_jax` carries a whole train
state across the same way: the LM's (step, f32 params, AdamW moments)
or ResNet's (step, f32 params, ``batch_stats``, the SGD trace), and
:func:`resnet_variables_from_jax` ResNet's ``{"params",
"batch_stats"}`` (HWIO conv kernels, which the port convolves with at
use). MoE blocks carry their ``moe`` subtree (router, expert weights) in
the parameters and in AdamW's moments. Names and
layouts stay as they are: a Dense ``kernel`` stays (in, out), which is
what the GEMV and the fused QKV kernel contract, and the embedding
stays (vocab, dim), which is what the tied head reads with
``transpose_w``. Matmul weights are cast to the compute
dtype once here (the reference casts on every call, to the same
values); norm scales stay f32. The pipelined LM's layout
(``models/pipeline_lm``: ``blocks`` leaves stacked over depth) carries
across the same way, leaf by leaf.

:func:`shard_state` lays a whole state (converted, or built without a
mesh) onto a mesh, each rank keeping its shards, at the placements of
:func:`mesh_form`, which a restore onto a mesh reads too; :func:`gather_state`
assembles a mesh state whole again. The reference's sharded arrays come
to numpy whole through ``np.asarray``, so a converted state is always
whole first.
"""

from __future__ import annotations

import dataclasses
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
from kubeflow_tpu_torch.models.optim import (
    map_param_trees,
    tree_map_with_path,
)
from kubeflow_tpu_torch.models.resnet import ResNet
from kubeflow_tpu_torch.models.train import TrainState, state_shardings
from kubeflow_tpu_torch.models.transformer import (
    LM_TP_RULES,
    LMConfig,
    TransformerLM,
    build_lm,
)
from kubeflow_tpu_torch.parallel.mesh import gather_block, local_block

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
        elif key == "blocks":
            # The pipelined layout: every leaf stacked over depth.
            out[key] = {name: {leaf_name: _tensor(
                value, dev, torch.float32 if name in _F32_LEAVES else dtype)
                for leaf_name, value in leaf.items()}
                for name, leaf in sub.items()}
        elif key.startswith("block_"):
            blk = {}
            for name, leaf in sub.items():
                if name == "moe":
                    # The router stays f32 (the reference's f32 Dense);
                    # the expert weights take the matmul dtype.
                    blk[name] = {
                        "router": {"kernel": _tensor(
                            leaf["router"]["kernel"], dev, torch.float32)},
                        "experts_up": _tensor(leaf["experts_up"], dev, dtype),
                        "experts_down": _tensor(leaf["experts_down"], dev,
                                                dtype)}
                    continue
                (leaf_name, value), = leaf.items()
                leaf_dtype = torch.float32 if name in _F32_LEAVES else dtype
                blk[name] = {leaf_name: _tensor(value, dev, leaf_dtype)}
            out[key] = blk
        else:
            raise ValueError(f"unexpected parameter group {key!r}")
    missing = [] if "blocks" in out else [
        f"block_{i}" for i in range(cfg.layers) if f"block_{i}" not in out]
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


def mesh_form(state: TrainState, mesh, tp_rules: dict | None = None,
              apply_fn=None) -> tuple[dict, Any]:
    """The placements (:func:`~kubeflow_tpu_torch.models.train.
    state_shardings`) and the ``apply_fn`` that the whole ``state`` takes
    on ``mesh``. For the LM both come from the model: its config built
    on the mesh (``build_lm(cfg, mesh)``, unless ``apply_fn`` or the
    state's model is on it already) and its layout,
    ``transformer.LM_TP_RULES``, which its tp blocks compute with, so
    ``tp_rules`` may be None or those rules and nothing else. The
    pipelined LM's come from its model the same way: the model on
    ``mesh`` and ``pipeline_lm.pp_param_sharding`` (blocks on pp). Any
    other state takes ``tp_rules`` as given and keeps its ``apply_fn``
    (ResNet's model takes its BatchNorm group per call)."""
    from kubeflow_tpu_torch.models.pipeline_lm import (
        PipelinedLM,
        pp_state_shardings,
    )

    apply_fn = apply_fn or state.apply_fn
    if isinstance(apply_fn, (TransformerLM, PipelinedLM)) and (
            tp_rules is not None and tp_rules != LM_TP_RULES):
        raise ValueError("the LM's tp layout is LM_TP_RULES; a state "
                         "placed by other rules would not match what "
                         "its blocks compute")
    if isinstance(apply_fn, PipelinedLM):
        if apply_fn.mesh is not mesh:
            apply_fn = dataclasses.replace(apply_fn, mesh=mesh)
        return pp_state_shardings(state, mesh), apply_fn
    if isinstance(apply_fn, TransformerLM):
        tp_rules = LM_TP_RULES
        if apply_fn.mesh is not mesh:
            apply_fn = build_lm(apply_fn.cfg, mesh=mesh)
    return state_shardings(state, mesh, tp_rules), apply_fn


def shard_state(state: TrainState, mesh, tp_rules: dict | None = None,
                apply_fn=None) -> TrainState:
    """A WHOLE state laid onto ``mesh``: each rank keeps its block of
    every leaf at the placements of :func:`mesh_form` (the moments and
    the trace at their parameter's placement), sliced where the state
    lies and only then moved to the mesh's device, so a state made in
    host memory never reaches the card whole; the parameters require
    grad. The new state's ``apply_fn`` is :func:`mesh_form`'s."""
    placements, apply_fn = mesh_form(state, mesh, tp_rules, apply_fn)

    def shard(group):
        def leaf(path, t):
            return local_block(mesh, t.detach(),
                               placements[group][path]).to(mesh.device)
        return lambda tree: tree_map_with_path(leaf, tree)

    return dataclasses.replace(
        state, params=trainable(shard("params")(state.params)),
        opt_state=map_param_trees(state.opt_state, shard("params")),
        batch_stats=shard("batch_stats")(state.batch_stats),
        apply_fn=apply_fn, mesh=mesh, placements=placements)


def gather_state(state: TrainState) -> TrainState:
    """A mesh state assembled whole on every rank (a collective: every
    rank calls it), for comparing with a meshless run. Its ``apply_fn``
    is the LM's config built without a mesh, else the state's own."""
    mesh, placements = state.mesh, state.placements

    def whole(group):
        def leaf(path, t):
            return gather_block(mesh, t.detach(), placements[group][path])
        return lambda tree: tree_map_with_path(leaf, tree)

    apply_fn = state.apply_fn
    if isinstance(apply_fn, TransformerLM):
        apply_fn = build_lm(apply_fn.cfg)
    return dataclasses.replace(
        state, params=trainable(whole("params")(state.params)),
        opt_state=map_param_trees(state.opt_state, whole("params")),
        batch_stats=whole("batch_stats")(state.batch_stats),
        apply_fn=apply_fn, mesh=None, placements=None)

"""Faults planted under a run's timed path, for the fault tests (on the
CPU, in tiny cells) and for their readings at a cell's own size
(``tools/readings.py --fault``).

A tiny cell keeps its cell's limits; its training computes in f32,
where a sound run reads ~1e-6 and so passes them."""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark import harness


def tiny(cell):
    """A one-second Context for ``cell`` (its name in ``BENCHMARK.json``,
    or an entry of the same form) at a CPU size, with the cell's
    limits."""
    c = (harness.find_cell(harness.manifest(), cell)
         if isinstance(cell, str) else cell)
    cfg = harness.config(c["config"])
    mix = harness.traffic(c["traffic"])
    if cfg["model"] == "lm":
        cfg.update(vocab=512, layers=2, dim=64, heads=2, kv_heads=2,
                   head_dim=32)
        cfg["train"] = dict(cfg["train"], compute_dtype="float32")
    else:
        cfg.update(image_size=32, classes=10, width=8,
                   stage_sizes=[1, 1, 1, 1], compute_dtype="float32",
                   image_dtype="float32")
    if mix["driver"] == "train_lm":
        mix.update(batch=4, seq=128, pool_batches=4, trace_after_s=0.2,
                   trace_steps=2)
        mix["documents"] = dict(mix["documents"], median=32, min=4, max=128)
    else:
        mix.update(batch=8, trace_after_s=0.2, trace_steps=2)
    return harness.Context(config=cfg, mix=mix,
                           limits=harness.limits(c["name"]), seed=2 ** 31 + 11,
                           seconds=1.0, trace=False,
                           setup_start=time.perf_counter(),
                           device=torch.device("cpu"))


def _tensors(node, out):
    if isinstance(node, torch.Tensor):
        out.append(node)
    elif isinstance(node, dict):
        for v in node.values():
            _tensors(v, out)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _tensors(v, out)
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            _tensors(getattr(node, f.name), out)
    return out


def unchanged_state(step):
    """A step that returns its state as it found it (the loss as
    computed)."""
    def planted(state, batch):
        held = _tensors([state.params, state.opt_state], [])
        saved = [t.detach().clone() for t in held]
        count = getattr(state.opt_state, "count", None)   # AdamW's
        count = count if isinstance(count, int) else None
        state, out = step(state, batch)
        with torch.no_grad():
            for t, s in zip(held, saved):
                t.copy_(s)
        if count is not None:
            state.opt_state.count = count
        return state, out
    return planted


def half_batch(step):
    """A step that leaves out half of the batch and means over the
    rest."""
    def planted(state, batch):
        rows = next(iter(batch.values())).shape[0] // 2
        return step(state, {k: v[:rows] for k, v in batch.items()})
    return planted


def exchange_left_out(step):
    """A mesh step whose exchange between cards is left out: every
    BatchNorm's moments and every gradient stay this rank's own."""
    from kubeflow_tpu_torch.models import resnet, train

    def planted(state, batch):
        held = resnet.all_reduce, train.reduce_gradients
        resnet.all_reduce = lambda t, group: t
        train.reduce_gradients = lambda mesh, grads, axes: list(grads)
        try:
            return step(state, batch)
        finally:
            resnet.all_reduce, train.reduce_gradients = held
    return planted


STEP_FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
               "exchange_left_out": exchange_left_out}

#!/usr/bin/env python3
"""Check the port's mesh training across the cards of one host, NCCL
between real ranks: a fault check, not a timing.

One process per card, started the way torchrun starts them (pod rank 0,
``LOCAL_WORLD_SIZE`` = cards, ``LOCAL_RANK`` = the card), each forming
the world with ``initialize_from_env`` (NCCL, coordinator
``127.0.0.1:<free port>``). For each mesh spec below every rank takes
one step on the mesh and the same step without a mesh on its own card
on the whole batch, from the same seed, and compares them:

- LM in f32 (the plain attention core, TF32 off; ring attention under
  sp): the loss within 1e-5 relative, each leaf's gradient within 1e-4
  and each leaf's AdamW update (parameters after the step minus before)
  within 1e-4 in relative norm. These are the CPU tests' limits; f32
  summation order moves them by ~1e-6. Dropping the 3 shard-boundary
  positions of each 1024-token row under sp=4 (a next-token shift that
  stops at the shard) moves the loss by 3.6e-5 and a gradient by 5.6e-2
  at this size in f32. The optimizer here (F32_LR, F32_EPS, f32
  moments) makes the update a smooth function of the gradient and large
  beside the parameters' f32 spacing; with the default eps a first AdamW
  step is lr * sign(g), which flips wherever rounding crosses zero, and
  at lr 3e-4 a norm scale of 1 moves in steps of 4e-4 of its update.
- LM in bf16 (the flash kernels on each rank's local heads): the loss
  within 1e-4 relative, each gradient within 5e-2 in relative norm
  (bf16 rounding lands differently when a product is split over ranks
  or a ring hop replaces the flash kernel). The update is printed, not
  held: a first AdamW step is lr * sign(g), which flips with that
  rounding.
- ResNet (resnet18, f32, TF32 off): the loss within 1e-5, every leaf of
  params and batch_stats within 1e-4 in relative norm.
- Memory, on the cards: each rank's state bytes at rest, and its peak
  allocation over the state's creation and over one step, above what
  was allocated before, for the train phase's LM (8 x 1024, vocab
  32768, bf16, batch 4 x 512), mesh and meshless. Held: fsdp over every
  card steps below dp over every card (each rank's step peak under
  fsdp below every rank's under dp: fsdp gathers one block's weights at
  a time and reduce-scatters their gradients in the backward). Beside
  it, on dp and fsdp over every card, ResNet-50's state and step peak
  at 64 images of 224x224 (bf16) a step, printed, not held: its fsdp
  step too gathers one block's weights at a time.
- MoE in f32 (the LM above with 4 experts in every 2nd block, top-2):
  on ep over every card, and on sp=2 x ep (cards / 2), against the
  meshless step with the LM's f32 limits. A rank that skips the
  combine's all-reduce over ep, or MoE gradients summed over sp as
  well, fails them.
- Checkpoints: the f32 LM stepped once on fsdp over every card and
  saved (each rank its blocks: the shard files' bytes sum to one copy of
  the state, held), then restored onto dp x tp, tp, sp and a mesh of
  one card (rank 0 alone): every leaf bit-equal to the saved state and
  the restore classified cross-topology (held); on each mesh of every
  card one more step against the meshless step from the same restored
  state, within the f32 limits (held).

- Pipelines in f32 (the plain core, TF32 off): the LM at 8 layers
  (``pp_config``) through ``make_pp_lm_train_step`` on each of PP_SPECS
  (pp over every card, dp2 x pp2, pp2 x sp2, pp2 x tp2 at 4 cards),
  M = 4 microbatches, with gpipe, 1f1b and 1f1b with 2 virtual stages,
  each from ``create_pp_lm_state`` with seed 0 (the meshless LM's
  weights, stacked) against the meshless step on each card: the LM's
  f32 limits. Then a pp checkpoint: the f32 pipelined state stepped once
  on pp over every card, saved, restored onto the same mesh and onto
  one card (rank 0 alone), every leaf bit-equal (held). On the cards,
  each rank's step peak above what was allocated before for gpipe and
  1F1B at M = 4 and 16 on pp over every card (the train phase's LM,
  batch 16 x 512), printed, not held.

Rank 0 prints one JSON line per spec, then the ``moe``, ``ckpt``,
``pp`` (one per pp spec), ``pp_ckpt``, ``memory`` and ``pp_memory``
lines, and the card's name and power limit; the script exits 1 if any
held check fails.

Run from the root of a checkout on a host with 2 to 8 cards and nvcc:
``python3 testing/torch_mesh_check.py [cards]`` (default 4). With
``--cpu`` the same runs on 4 gloo ranks on the CPU at a small size (the
kernels' plain twins, no memory readings), as a rehearsal.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

LR = 3e-4
# (loss rtol, gradient rtol, update rtol or None) per LM precision.
LM_LIMITS = {"f32": (1e-5, 1e-4, 1e-4), "bf16": (1e-4, 5e-2, None)}
# The f32 check's AdamW: a first step is lr * g / (|g| + eps) (f32
# moments). eps above the gradients' rounding keeps it smooth in g; an
# lr far above the parameters' f32 spacing (2^-23 at a norm scale of 1)
# keeps p + update from rounding by more than the gradients differ.
F32_LR, F32_EPS = 0.1, 1e-3
RESNET_LOSS_RTOL, RESNET_RTOL = 1e-5, 1e-4
# Mesh specs per world size (dp takes what is left).
SPECS = {
    4: [dict(dp=4), dict(dp=1, fsdp=4), dict(dp=1, tp=4), dict(dp=1, sp=4),
        dict(dp=2, sp=2), dict(dp=1, fsdp=2, tp=2)],
    2: [dict(dp=2), dict(dp=1, fsdp=2), dict(dp=1, tp=2), dict(dp=1, sp=2)],
}


# MoE and checkpoint specs per world size.
MOE_SPECS = {4: [dict(dp=1, ep=4), dict(dp=1, sp=2, ep=2)],
             2: [dict(dp=1, ep=2)]}
CKPT_TARGETS = {4: [dict(dp=2, tp=2), dict(dp=1, tp=4), dict(dp=1, sp=4)],
                2: [dict(dp=1, tp=2), dict(dp=1, sp=2)]}
MOE = dict(moe_experts=4, moe_top_k=2)
# The memory line's ResNet-50 batch (224x224 bf16), split over the ranks.
RESNET_MEMORY_BATCH = 64
# Pipeline specs per world size, the schedules each runs, and the
# microbatch counts of the step-peak readings.
PP_SPECS = {4: [dict(dp=1, pp=4), dict(dp=2, pp=2), dict(dp=1, pp=2, sp=2),
                dict(dp=1, pp=2, tp=2)],
            2: [dict(dp=1, pp=2)]}
PP_SCHEDULES = {"gpipe": {}, "1f1b": {"schedule": "1f1b"},
                "1f1b_v2": {"schedule": "1f1b", "virtual_stages": 2}}
PP_MICROBATCHES = 4
PP_MEMORY_MICROBATCHES = (4, 16)


def lm_config(torch, precision: str, cpu: bool, **extra):
    from kubeflow_tpu_torch.models import LMConfig

    dtype = torch.float32 if precision == "f32" else torch.bfloat16
    if cpu:
        return LMConfig(vocab=256, layers=2, dim=64, heads=4,
                        dtype=dtype, **extra), (8, 64)
    return LMConfig(vocab=8192, layers=2, dim=512, heads=4,
                    dtype=dtype, **extra), (8, 1024)


def f32_adamw(torch, precision: str):
    from kubeflow_tpu_torch.models import AdamW

    opt = (dict(lr=F32_LR, eps=F32_EPS, mu_dtype=torch.float32)
           if precision == "f32" else dict(lr=LR, mu_dtype=torch.bfloat16))
    return Recording(AdamW(weight_decay=0.01, **opt))


def rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


class Recording:
    """The wrapped optimizer, keeping the gradients it is given."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params):
        self.grads = [g.detach().clone() for g in grads]
        self.tx.update(grads, state, params)


def step_pair(torch, states: dict, cfg, tokens, before: dict) -> dict:
    """One step of each of ``states`` ({"meshless": state, "mesh":
    state on its mesh}, each with a :class:`Recording` optimizer): its
    loss, its whole gradients and its update (parameters after the step
    minus ``before``) by path."""
    from kubeflow_tpu_torch.models import gather_state, make_lm_train_step
    from kubeflow_tpu_torch.models.optim import flatten
    from kubeflow_tpu_torch.parallel import gather_block

    runs = {}
    for name, state in states.items():
        m = state.mesh
        tx = state.tx
        state, metrics = make_lm_train_step(m, cfg=cfg)(
            state, {"tokens": tokens})
        paths = [p for p, _ in flatten(state.params)]
        grads = dict(zip(paths, tx.grads))
        if m is not None:
            grads = {p: gather_block(m, g, state.placements["params"][p])
                     for p, g in grads.items()}
            state = gather_state(state)
        updates = {p: t.detach() - before[p]
                   for p, t in flatten(state.params)}
        runs[name] = (float(metrics["loss"]), grads, updates)
    return runs


def lm_check(torch, mesh, precision: str, cpu: bool, **extra) -> dict:
    from kubeflow_tpu_torch.models import (
        build_lm,
        create_lm_state,
        init_params,
    )
    from kubeflow_tpu_torch.models.optim import flatten

    cfg, shape = lm_config(torch, precision, cpu, **extra)
    gen = torch.Generator(device=mesh.device).manual_seed(17)
    tokens = torch.randint(0, cfg.vocab, shape, generator=gen,
                           device=mesh.device)
    before = dict(flatten(init_params(cfg, seed=0, device=mesh.device)))
    states = {name: create_lm_state(
        build_lm(cfg, m, use_flash=None if precision == "bf16" else False),
        seed=0, tx=f32_adamw(torch, precision), mesh=m, device=mesh.device)
        for name, m in (("meshless", None), ("mesh", mesh))}
    return compare(step_pair(torch, states, cfg, tokens, before), precision)


def compare(runs: dict, precision: str) -> dict:
    """The mesh run against the meshless one, within LM_LIMITS."""
    loss, grads, updates = runs["mesh"]
    want_loss, want_grads, want_updates = runs["meshless"]
    loss_err = abs(loss - want_loss) / abs(want_loss)
    grad_err = max((rel(grads[p], want_grads[p]), p) for p in want_grads)
    update_err = max((rel(updates[p], want_updates[p]), p)
                     for p in want_updates)
    loss_tol, grad_tol, update_tol = LM_LIMITS[precision]
    return {"loss": loss, "meshless_loss": want_loss,
            "loss_rel_err": loss_err,
            "grad_rel_err_max": grad_err[0], "worst_grad": grad_err[1],
            "update_rel_err_max": update_err[0],
            "worst_update": update_err[1],
            "limits": {"loss": loss_tol, "grad": grad_tol,
                       "update": update_tol},
            "ok": (loss_err <= loss_tol and grad_err[0] <= grad_tol
                   and (update_tol is None or update_err[0] <= update_tol))}


def lm_memory(torch, mesh) -> dict:
    """Per rank, in MB: the state at rest, and the peak allocation over
    the state's creation and over one step above what was allocated
    before each, for the train phase's LM, mesh and meshless."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import (
        LMConfig,
        build_lm,
        create_lm_state,
        make_lm_train_step,
    )
    from kubeflow_tpu_torch.models.optim import flatten

    cfg = LMConfig(vocab=32768, layers=8, dim=1024, heads=8,
                   dtype=torch.bfloat16)
    gen = torch.Generator(device=mesh.device).manual_seed(23)
    tokens = torch.randint(0, cfg.vocab, (4, 512), generator=gen,
                           device=mesh.device)
    mb = 2.0 ** -20
    out = {}
    for name, m in (("meshless", None), ("mesh", mesh)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state = create_lm_state(build_lm(cfg, m), seed=0, mesh=m,
                                device=mesh.device)
        torch.cuda.synchronize()
        create_peak = torch.cuda.max_memory_allocated() - base
        leaves = [t for _, t in flatten(state.params)] + [
            t for tree in (state.opt_state.mu, state.opt_state.nu)
            for _, t in flatten(tree)]
        at_rest = sum(t.numel() * t.element_size() for t in leaves)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, metrics = make_lm_train_step(m, cfg=cfg)(
            state, {"tokens": tokens})
        float(metrics["loss"])
        step_peak = torch.cuda.max_memory_allocated() - base
        mine = [round(at_rest * mb, 1), round(create_peak * mb, 1),
                round(step_peak * mb, 1)]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        out[name] = {"state_mb": [r[0] for r in every],
                     "create_peak_mb": [r[1] for r in every],
                     "step_peak_mb": [r[2] for r in every]}
        del state, metrics
        torch.cuda.empty_cache()
    return out


def _tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested state (dicts, sequences and
    objects with attributes, as the optimizers' states are)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    if hasattr(tree, "__dict__"):
        return sum(_tensor_bytes(v) for v in vars(tree).values())
    return 0


def resnet_memory(torch, mesh) -> dict:
    """Per rank, in MB: ResNet-50's state at rest (parameters,
    batch_stats and the SGD trace) and its peak allocation over one step
    above what was allocated before, at RESNET_MEMORY_BATCH images of
    224x224 bf16 over the mesh's (dp, fsdp) ranks. Printed beside the
    LM's readings, not held."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import (
        create_train_state,
        make_train_step,
        resnet50,
    )

    shape = (RESNET_MEMORY_BATCH, 224, 224, 3)
    gen = torch.Generator(device=mesh.device).manual_seed(29)
    batch = {"image": torch.randn(shape, generator=gen, device=mesh.device)
             .to(torch.bfloat16),
             "label": torch.randint(0, 1000, (shape[0],), generator=gen,
                                    device=mesh.device)}
    torch.cuda.synchronize()
    state = create_train_state(resnet50(num_classes=1000), 0, shape,
                               mesh=mesh, device=mesh.device)
    at_rest = sum(_tensor_bytes(getattr(state, group)) for group in (
        "params", "batch_stats", "opt_state"))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = make_train_step(mesh)(state, batch)
    float(metrics["loss"])
    step_peak = torch.cuda.max_memory_allocated() - base
    mb = 2.0 ** -20
    mine = [round(at_rest * mb, 1), round(step_peak * mb, 1)]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    del state, metrics, batch
    torch.cuda.empty_cache()
    return {"state_mb": [r[0] for r in every],
            "step_peak_mb": [r[1] for r in every]}


def ckpt_check(torch, cpu: bool, root: str) -> dict:
    """Save the f32 LM, stepped once on fsdp over every card, then
    restore it onto each of CKPT_TARGETS and a mesh of rank 0 alone:
    bit-equal, cross-topology, and (meshes of every card) one more step
    against the meshless step from the same state."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import (
        build_lm,
        create_lm_state,
        gather_state,
        make_lm_train_step,
    )
    from kubeflow_tpu_torch.models.checkpoint import (
        CheckpointManager,
        CheckpointMetrics,
        _arrays_only,
        _flatten_keys,
    )
    from kubeflow_tpu_torch.models.optim import flatten
    from kubeflow_tpu_torch.parallel import AXES, MeshSpec, make_mesh

    device = "cpu" if cpu else None
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg, shape = lm_config(torch, "f32", cpu)
    source = make_mesh(MeshSpec(dp=1, fsdp=world), device=device)
    gen = torch.Generator(device=source.device).manual_seed(29)
    tokens = [torch.randint(0, cfg.vocab, shape, generator=gen,
                            device=source.device) for _ in range(2)]

    def fresh(mesh, seed):
        return create_lm_state(build_lm(cfg, mesh, use_flash=False),
                               seed=seed, tx=f32_adamw(torch, "f32"),
                               mesh=mesh, device=source.device)

    def manager(mesh, **kw):
        return CheckpointManager(root, process_id=mesh.rank,
                                 process_count=mesh.size(AXES),
                                 fingerprint={"mesh": list(mesh.spec.shape)},
                                 **kw)

    def leaves(state):
        return dict(_flatten_keys(_arrays_only(state)))

    def equal(a, b) -> bool:
        la, lb = leaves(a), leaves(b)
        return la.keys() == lb.keys() and all(
            torch.equal(x, lb[k]) if isinstance(x, torch.Tensor)
            else int(x) == int(lb[k]) for k, x in la.items())

    state, _ = make_lm_train_step(source, cfg=cfg)(
        fresh(source, 0), {"tokens": tokens[0]})
    manager(source).save(1, state)
    saved = gather_state(state)
    wrote = [None] * world
    dist.all_gather_object(wrote, os.path.getsize(
        os.path.join(root, "1", f"shard-{rank:05d}.bin")))
    copy = sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor)
               else 4 for t in leaves(saved).values())
    out = {"source": source.shape, "wrote": wrote, "copy_bytes": copy,
           "bytes_ok": sum(wrote) == copy, "targets": []}
    ok = out["bytes_ok"]
    before = {p: t.detach().clone() for p, t in flatten(saved.params)}
    for spec in CKPT_TARGETS[world] + [None]:
        ranks = None if spec is not None else [0]
        mesh = make_mesh(MeshSpec(**(spec or {})), device=device,
                         ranks=ranks)
        line = {"spec": spec or "one card"}
        if mesh is not None:
            metrics = CheckpointMetrics()
            mgr = manager(mesh, metrics=metrics)
            restored, _ = mgr.restore_latest_valid(fresh(mesh, 1))
            line["bit_equal"] = equal(gather_state(restored), saved)
            line["cross_topology"] = mgr.last_restore["cross_topology"]
            good = line["bit_equal"] and line["cross_topology"]
            if spec is not None:
                # The meshless twin: the same step restored whole, into
                # tensors of its own.
                whole = CheckpointManager(root).restore(1, fresh(None, 2))
                restored.tx = f32_adamw(torch, "f32")
                line["step"] = compare(step_pair(
                    torch, {"meshless": whole, "mesh": restored}, cfg,
                    tokens[1], before), "f32")
                good = good and line["step"]["ok"]
            line["ok"] = good
        every = [None] * world
        dist.all_gather_object(every, line.get("ok", True))
        ok = ok and all(every)
        out["targets"].append(line)
    out["ok"] = ok
    return out


def pp_config(torch, cpu: bool):
    """The f32 pipeline check's LM: ``lm_config``'s at 8 layers (pp x
    virtual stages divide it), and its batch."""
    from kubeflow_tpu_torch.models import LMConfig

    if cpu:
        return LMConfig(vocab=256, layers=8, dim=64, heads=4,
                        dtype=torch.float32), (8, 64)
    return LMConfig(vocab=8192, layers=8, dim=512, heads=4,
                    dtype=torch.float32), (8, 1024)


def pp_check(torch, mesh, cpu: bool) -> dict:
    """The pipelined LM on ``mesh`` with each of PP_SCHEDULES against the
    meshless step on this card, within the f32 limits."""
    from kubeflow_tpu_torch.models import (
        PipelinedLM,
        build_lm,
        create_lm_state,
        create_pp_lm_state,
        gather_state,
        init_params,
        make_lm_train_step,
        make_pp_lm_train_step,
    )
    from kubeflow_tpu_torch.models.optim import flatten, tree_map_with_path
    from kubeflow_tpu_torch.models.pipeline_lm import stack_blocks
    from kubeflow_tpu_torch.parallel import gather_block

    cfg, shape = pp_config(torch, cpu)
    gen = torch.Generator(device=mesh.device).manual_seed(37)
    tokens = torch.randint(0, cfg.vocab, shape, generator=gen,
                           device=mesh.device)
    batch = {"tokens": tokens}

    def stacked(tree):
        return dict(flatten(stack_blocks(cfg, tree)))

    before = stacked(init_params(cfg, seed=0, device=mesh.device))
    state = create_lm_state(build_lm(cfg, use_flash=False), seed=0,
                            tx=f32_adamw(torch, "f32"), device=mesh.device)
    tx = state.tx
    state, metrics = make_lm_train_step(cfg=cfg)(state, batch)
    by_path = dict(zip([p for p, _ in flatten(state.params)], tx.grads))
    grads = stacked(tree_map_with_path(lambda p, _: by_path[p],
                                       state.params))
    meshless = (float(metrics["loss"]), grads, {
        p: t.detach() - before[p] for p, t in stacked(state.params).items()})
    out = {}
    for name, kw in PP_SCHEDULES.items():
        model = PipelinedLM(cfg, mesh, num_microbatches=PP_MICROBATCHES,
                            use_flash=False, **kw)
        pstate = create_pp_lm_state(model, seed=0,
                                    tx=f32_adamw(torch, "f32"))
        ptx = pstate.tx
        pstate, pmetrics = make_pp_lm_train_step(model)(pstate, batch)
        placements = pstate.placements["params"]
        pgrads = {p: gather_block(mesh, g, placements[p]) for (p, _), g in
                  zip(flatten(pstate.params), ptx.grads)}
        after = dict(flatten(gather_state(pstate).params))
        out[name] = compare({
            "mesh": (float(pmetrics["loss"]), pgrads,
                     {p: t.detach() - before[p] for p, t in after.items()}),
            "meshless": meshless}, "f32")
    return out


def pp_ckpt_check(torch, cpu: bool, root: str) -> dict:
    """The f32 pipelined state stepped once on pp over every card and
    saved, then restored onto the same mesh and onto one card (rank 0
    alone): every leaf bit-equal to the saved state."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import (
        PipelinedLM,
        create_pp_lm_state,
        gather_state,
        make_pp_lm_train_step,
    )
    from kubeflow_tpu_torch.models.checkpoint import (
        CheckpointManager,
        _arrays_only,
        _flatten_keys,
    )
    from kubeflow_tpu_torch.parallel import AXES, MeshSpec, make_mesh

    device = "cpu" if cpu else None
    world = dist.get_world_size()
    cfg, shape = pp_config(torch, cpu)
    source = make_mesh(MeshSpec(dp=1, pp=world), device=device)
    gen = torch.Generator(device=source.device).manual_seed(41)
    tokens = torch.randint(0, cfg.vocab, shape, generator=gen,
                           device=source.device)

    def fresh(mesh, seed):
        model = PipelinedLM(cfg, mesh, num_microbatches=PP_MICROBATCHES,
                            use_flash=False)
        return model, create_pp_lm_state(model, seed=seed,
                                         tx=f32_adamw(torch, "f32"))

    def manager(mesh):
        return CheckpointManager(root, process_id=mesh.rank,
                                 process_count=mesh.size(AXES),
                                 fingerprint={"mesh": list(mesh.spec.shape)})

    def equal(a, b) -> bool:
        la = dict(_flatten_keys(_arrays_only(a)))
        lb = dict(_flatten_keys(_arrays_only(b)))
        return la.keys() == lb.keys() and all(
            torch.equal(x, lb[k]) if isinstance(x, torch.Tensor)
            else int(x) == int(lb[k]) for k, x in la.items())

    model, state = fresh(source, 0)
    state, _ = make_pp_lm_train_step(model)(state, {"tokens": tokens})
    manager(source).save(1, state)
    saved = gather_state(state)
    out, ok = {"source": source.shape, "targets": []}, True
    for spec, ranks in ((dict(dp=1, pp=world), None), (dict(), [0])):
        mesh = make_mesh(MeshSpec(**spec), device=device, ranks=ranks)
        line = {"spec": spec or "one card"}
        if mesh is not None:
            restored, _ = manager(mesh).restore_latest_valid(
                fresh(mesh, 1)[1])
            line["bit_equal"] = equal(gather_state(restored), saved)
            line["pp"] = restored.placements["params"][
                "blocks/q_proj/kernel"][0]
        every = [None] * world
        dist.all_gather_object(every, line.get("bit_equal", True))
        ok = ok and all(every)
        out["targets"].append(line)
    out["ok"] = ok
    return out


def pp_memory(torch, mesh) -> dict:
    """Per rank, in MB: the step peak above what was allocated before
    of the train phase's LM (batch 16 x 512) on ``mesh`` with gpipe and
    1F1B at each of PP_MEMORY_MICROBATCHES."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import (
        LMConfig,
        PipelinedLM,
        create_pp_lm_state,
        make_pp_lm_train_step,
    )

    cfg = LMConfig(vocab=32768, layers=8, dim=1024, heads=8,
                   dtype=torch.bfloat16)
    gen = torch.Generator(device=mesh.device).manual_seed(43)
    tokens = torch.randint(0, cfg.vocab, (16, 512), generator=gen,
                           device=mesh.device)
    out = {}
    for m in PP_MEMORY_MICROBATCHES:
        for name in ("gpipe", "1f1b"):
            model = PipelinedLM(cfg, mesh, num_microbatches=m,
                                **PP_SCHEDULES[name])
            state = create_pp_lm_state(model, seed=0)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            state, metrics = make_pp_lm_train_step(model)(
                state, {"tokens": tokens})
            float(metrics["loss"])
            peak = round((torch.cuda.max_memory_allocated() - base)
                         * 2.0 ** -20, 1)
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, peak)
            out[f"{name}_m{m}_step_peak_mb"] = every
            del state, metrics
            torch.cuda.empty_cache()
    return out


def moe_check(torch, mesh, cpu: bool) -> dict:
    """The MoE LM in f32 on ``mesh`` against the meshless step."""
    return lm_check(torch, mesh, "f32", cpu, **MOE)


def resnet_check(torch, mesh) -> dict:
    from kubeflow_tpu_torch.models import (
        create_train_state,
        gather_state,
        make_train_step,
        resnet18,
    )
    from kubeflow_tpu_torch.models.optim import flatten

    model = resnet18(num_classes=10, width=16, dtype=torch.float32)
    gen = torch.Generator(device=mesh.device).manual_seed(19)
    batch = {"image": torch.randn((16, 32, 32, 3), generator=gen,
                                  device=mesh.device),
             "label": torch.randint(0, 10, (16,), generator=gen,
                                    device=mesh.device)}
    runs = {}
    for name, m in (("meshless", None), ("mesh", mesh)):
        state = create_train_state(model, 0, (16, 32, 32, 3), mesh=m,
                                   device=mesh.device)
        state, metrics = make_train_step(m)(state, batch)
        if m is not None:
            state = gather_state(state)
        runs[name] = (float(metrics["loss"]),
                      {**{f"p/{k}": v.detach()
                          for k, v in flatten(state.params)},
                       **{f"s/{k}": v for k, v in
                          flatten(state.batch_stats)}})
    loss, leaves = runs["mesh"]
    want_loss, want = runs["meshless"]
    rms = (sum(float(v.detach().double().pow(2).sum())
               for v in want.values())
           / sum(v.numel() for v in want.values())) ** 0.5
    err = max((float((leaves[k].double() - v.double()).norm())
               / max(float(v.double().norm()),
                     2.0 ** -8 * rms * v.numel() ** 0.5), k)
              for k, v in want.items())
    return {"loss": loss, "meshless_loss": want_loss,
            "loss_rel_err": abs(loss - want_loss) / abs(want_loss),
            "leaf_rel_err_max": err[0], "worst_leaf": err[1],
            "ok": (abs(loss - want_loss) <= RESNET_LOSS_RTOL * abs(want_loss)
                   and err[0] <= RESNET_RTOL)}


def rank_main(cpu: bool) -> int:
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import (
        MeshSpec,
        initialize_from_env,
        make_mesh,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cpu" if cpu else None
    initialize_from_env(device=device)
    world = dist.get_world_size()
    ok, memory = True, {}

    def report(line):
        if dist.get_rank() == 0:
            print(json.dumps(line), flush=True)

    for spec in SPECS[world]:
        mesh = make_mesh(MeshSpec(**spec), device=device)
        line = {"spec": spec, "backend": dist.get_backend(),
                "lm_f32": lm_check(torch, mesh, "f32", cpu),
                "lm_bf16": lm_check(torch, mesh, "bf16", cpu),
                "resnet": resnet_check(torch, mesh)}
        ok = ok and all(line[k]["ok"] for k in ("lm_f32", "lm_bf16",
                                                "resnet"))
        if not cpu:
            line["lm_memory"] = memory[json.dumps(spec)] = lm_memory(
                torch, mesh)
            if spec in (dict(dp=world), dict(dp=1, fsdp=world)):
                line["resnet_memory"] = memory[json.dumps(spec)][
                    "resnet"] = resnet_memory(torch, mesh)
        report(line)
    for spec in MOE_SPECS[world]:
        line = {"moe": spec, "lm_f32": moe_check(
            torch, make_mesh(MeshSpec(**spec), device=device), cpu)}
        ok = ok and line["lm_f32"]["ok"]
        report(line)
    scratch = REPO / "kubeflow_tpu_torch" / "build"
    scratch.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        root = [tmp]
        dist.broadcast_object_list(root, src=0)
        line = {"ckpt": ckpt_check(torch, cpu, root[0])}
        dist.barrier()
    ok = ok and line["ckpt"]["ok"]
    report(line)
    for spec in PP_SPECS[world]:
        line = {"pp": spec, "lm_f32": pp_check(
            torch, make_mesh(MeshSpec(**spec), device=device), cpu)}
        ok = ok and all(run["ok"] for run in line["lm_f32"].values())
        report(line)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        root = [tmp]
        dist.broadcast_object_list(root, src=0)
        line = {"pp_ckpt": pp_ckpt_check(torch, cpu, root[0])}
        dist.barrier()
    ok = ok and line["pp_ckpt"]["ok"]
    report(line)
    if not cpu:
        report({"pp_memory": pp_memory(
            torch, make_mesh(MeshSpec(dp=1, pp=world), device=device))})
    if not cpu:
        dp = memory[json.dumps(dict(dp=world))]["mesh"]["step_peak_mb"]
        fsdp = memory[json.dumps(dict(dp=1, fsdp=world))]["mesh"][
            "step_peak_mb"]
        held = max(fsdp) < min(dp)
        report({"memory": {
            "fsdp_step_peak_mb": fsdp, "dp_step_peak_mb": dp,
            "fsdp_below_dp": held,
            "resnet_fsdp": memory[json.dumps(dict(dp=1, fsdp=world))][
                "resnet"],
            "resnet_dp": memory[json.dumps(dict(dp=world))]["resnet"]}})
        ok = ok and held
    dist.destroy_process_group()
    return 0 if ok else 1


def main(argv: list[str]) -> int:
    cpu = "--cpu" in argv
    args = [a for a in argv if a != "--cpu"]
    cards = 4 if cpu or not args else int(args[0])
    if not cpu:
        import torch

        if torch.cuda.device_count() < cards:
            print(f"needs {cards} cards, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        from kubeflow_tpu_torch.ops import _build

        _build.library()   # one build, before the ranks load it
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(REPO), "TPU_WORKER_ID": "0",
           "KFT_NUM_PROCESSES": "1", "LOCAL_WORLD_SIZE": str(cards),
           "KFT_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank"] + (["--cpu"] if cpu else []),
        env={**env, "LOCAL_RANK": str(rank)}) for rank in range(cards)]
    codes = [proc.wait(timeout=1200) for proc in procs]
    if not cpu:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    return 0 if not any(codes) else 1


if __name__ == "__main__":
    if "--rank" in sys.argv:
        sys.exit(rank_main("--cpu" in sys.argv))
    sys.exit(main(sys.argv[1:]))

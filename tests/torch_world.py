"""Gloo worlds for the port's multi-rank CPU tests. NOT a test module.

:class:`World` starts ``world`` processes of this file, each one rank of
a ``torch.distributed`` world formed the way a notebook replica forms
it: ``initialize_from_env`` on the env ``slice_env_for_rank`` injects,
the coordinator at ``127.0.0.1:<free port>``, ``device="cpu"`` (gloo).
Each rank runs the named cases in order, every rank the same ones, and
pickles what they return; the parent (the pytest process, which holds
the JAX references) reads every rank's results. The ranks import torch
and the port only, never JAX, so a world starts in a few seconds.

A case is a function of this module taking keyword inputs (numpy
arrays, nested dicts of them, plain values) and returning a dict of
numpy arrays and plain values. A case that raises on every rank records
its traceback and the world goes on with the next case.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import traceback
import types
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """``world`` ranks started on ``tasks`` ([(case name, inputs dict),
    ...]); :meth:`wait` returns ``[{case name: result} for each rank]``.
    The parent may compute its references while the ranks run."""

    def __init__(self, world: int, tasks: list, workdir):
        self.world, self.workdir = world, Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        with open(self.workdir / "tasks.pkl", "wb") as fh:
            pickle.dump(tasks, fh)
        self._start()

    def _start(self):
        port = _free_port()
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_"))}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, str(self.workdir), str(rank),
             str(self.world), str(port)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for rank in range(self.world)]

    def _finish(self, timeout: float) -> list:
        logs = []
        try:
            for proc in self.procs:
                logs.append(proc.communicate(timeout=timeout)[0].decode())
                if "EADDRINUSE" in logs[0]:
                    break   # the other ranks wait on a foreign server
        finally:
            for proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return logs

    def wait(self, timeout: float = 300.0) -> list:
        logs = self._finish(timeout)
        if "EADDRINUSE" in logs[0]:
            # Another process took the free port before rank 0 bound it.
            self._start()
            logs = self._finish(timeout)
        for rank, proc in enumerate(self.procs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"rank {rank} of {self.world} exited {proc.returncode}:"
                    f"\n{logs[rank][-4000:] if rank < len(logs) else ''}")
        results = []
        for rank in range(self.world):
            with open(self.workdir / f"out_{rank}.pkl", "rb") as fh:
                results.append(pickle.load(fh))
        return results


def outputs(results: list, name: str) -> list:
    """Every rank's result of case ``name``; fails with the traceback a
    rank recorded instead of a result."""
    for rank, res in enumerate(results):
        out = res[name]
        if isinstance(out, dict) and "error" in out:
            raise AssertionError(f"rank {rank} {name}:\n{out['error']}")
    return [res[name] for res in results]


# ------------------------------------------------------------------ ranks


def _np(t):
    return t.detach().float().cpu().numpy().copy()


class Recording:
    """An optimizer that keeps the gradients it is given (this rank's
    reduced shards), then applies the wrapped one."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params):
        self.grads = [g.detach().clone() for g in grads]
        self.tx.update(grads, state, params)


def _mesh(spec):
    from kubeflow_tpu_torch.parallel import MeshSpec, make_mesh

    return make_mesh(MeshSpec(**spec), device="cpu")


def _whole_grads(mesh, tx, paths, placements):
    from kubeflow_tpu_torch.parallel import gather_block

    return {path: _np(gather_block(mesh, g, placements[path]))
            for path, g in zip(paths, tx.grads)}


def _whole(tree):
    from kubeflow_tpu_torch.models.optim import flatten

    return {path: _np(t) for path, t in flatten(tree)}


def case_world(env):
    """What ``initialize_from_env`` formed."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import DistributedEnv

    denv = DistributedEnv.from_env(env)
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "backend": dist.get_backend(),
            "process_id": denv.process_id,
            "num_processes": denv.num_processes}


def case_mesh_api():
    """``tests/test_parallel.py``'s cases that need a world: the axes,
    ``auto_mesh``, a batch's rows, the multislice mesh, and a spec
    refactored down to this world."""
    import torch

    from kubeflow_tpu_torch.parallel import (
        MeshSpec,
        auto_mesh,
        batch_sharding,
        local_block,
        make_mesh,
        make_multislice_mesh,
    )

    world = torch.distributed.get_world_size()
    out = {"auto_dp": auto_mesh(device="cpu").shape["dp"]}
    if world == 8:
        mesh = make_mesh(MeshSpec(dp=2, fsdp=2, tp=2), device="cpu")
        out["axis_names"] = mesh.axis_names
        out["shape"] = mesh.shape
        mesh = make_mesh(MeshSpec(dp=4, fsdp=2), device="cpu")
        out["batch_block"] = tuple(local_block(
            mesh, torch.zeros(16, 3), batch_sharding(mesh)).shape)
        slices = make_multislice_mesh(MeshSpec(dp=4, fsdp=2), num_slices=2,
                                      device="cpu")
        out["multislice"] = (slices.shape, slices.coords)
    else:
        small = MeshSpec(dp=2, fsdp=2, tp=2).resolve(8).refactor(world)
        out["refactored"] = make_mesh(small, device="cpu").shape
    return out


def case_ring(spec, q, k, v, causal=False, window=None, segment_ids=None,
              grad=False, live_only=False):
    """``make_ring_attention`` on whole-sequence inputs: this rank's
    output shard, the hops it computed, and with ``grad`` its blocks of
    the gradients of sum(out^2) (q, k, v). ``live_only`` makes every hop
    live (no dead-hop skip)."""
    import torch

    from kubeflow_tpu_torch.ops import ring

    mesh = _mesh(spec)
    hops = []
    real_hop, real_live = ring.ring_hop, ring.hop_live

    def counted(*args, **kw):
        hops.append(kw["src"])
        return real_hop(*args, **kw)

    ring.ring_hop = counted
    if live_only:
        ring.hop_live = lambda *a, **kw: True
    try:
        qkv = [torch.from_numpy(x).requires_grad_(grad) for x in (q, k, v)]
        seg = None if segment_ids is None else torch.from_numpy(segment_ids)
        out = ring.make_ring_attention(mesh, "sp", window)(
            *qkv, causal=causal, segment_ids=seg)
        result = {"out": _np(out), "sp": mesh.index("sp"),
                  "dp": mesh.index("dp"), "hops": hops}
        if grad:
            grads = torch.autograd.grad((out ** 2).sum(), qkv)
            cols = mesh.slice("sp", q.shape[2])
            result["grads"] = [_np(g[:, :, cols]) for g in grads]
        return result
    finally:
        ring.ring_hop, ring.hop_live = real_hop, real_live


def case_ring_errors(spec, q, k, v):
    """The ring's validation errors, as messages."""
    from kubeflow_tpu_torch.models import LMConfig
    from kubeflow_tpu_torch.ops.ring import make_ring_attention
    import torch

    mesh = _mesh(spec)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    q3 = torch.cat([q, q[:, :1]], dim=1)   # 3 q heads vs 2 kv heads
    calls = {
        "window0": lambda: make_ring_attention(mesh, "sp", window=0)(
            q, k, v, causal=True),
        "window_not_causal": lambda: make_ring_attention(
            mesh, "sp", window=8)(q, k, v, causal=False),
        "heads": lambda: make_ring_attention(mesh, "sp")(
            q3, k, v, causal=True),
        "config": lambda: LMConfig(attn_window=0),
    }
    errors = {}
    for name, call in calls.items():
        try:
            call()
            errors[name] = None
        except ValueError as exc:
            errors[name] = str(exc)
    return errors


class WholeCount:
    """Counts the fsdp-gathered whole weights alive (by storage) at each
    gather, the forward's and each one a backward node unpacks (recast
    and re-viewed as it was saved), while it wraps
    ``fsdp.GatherShard.forward`` and ``fsdp._Regather.unpack``: ``peak``
    is the most alive at once, ``gathers`` how many gathers ran."""

    def __init__(self, fsdp):
        from torch.multiprocessing.reductions import StorageWeakRef

        self._fsdp = fsdp
        self._forward = forward = fsdp.GatherShard.forward
        self._unpack = unpack = fsdp._Regather.unpack
        self._live: list = []
        self.peak = self.gathers = 0

        def note(whole):
            self._live = [r for r in self._live if not r.expired()]
            self._live.append(StorageWeakRef(whole.untyped_storage()))
            self.gathers += 1
            self.peak = max(self.peak, len(self._live))
            return whole

        fsdp.GatherShard.forward = staticmethod(
            lambda ctx, *args: note(forward(ctx, *args)))
        fsdp._Regather.unpack = lambda saved: note(unpack(saved))

    def close(self) -> None:
        self._fsdp.GatherShard.forward = staticmethod(self._forward)
        self._fsdp._Regather.unpack = self._unpack


def case_lm(spec, cfg, params, tokens, segment_ids=None, forward_tokens=None,
            forward_segment_ids=None, step=True, adamw=None):
    """The LM on a mesh from the reference's parameters (numpy): this
    rank's parameter shards, the model's output at its rows (every row of
    ``forward_tokens``) and sp columns (for an MoE config with what its
    blocks sow: ``moe_aux`` and ``moe_expert_load`` per block), and one
    train step on the whole batch: its loss, the whole gradients and
    parameters after it, and the most fsdp-gathered weights alive at
    once in the step (:class:`WholeCount`). ``adamw``: the optimizer's
    ``lr`` and ``eps`` with f32 moments, else the reference LM's."""
    import torch

    from kubeflow_tpu_torch.parallel import fsdp
    from kubeflow_tpu_torch.models import (
        AdamW,
        LMConfig,
        TrainState,
        build_lm,
        gather_state,
        make_lm_train_step,
        params_from_jax,
        shard_state,
    )
    from kubeflow_tpu_torch.models.optim import flatten, trainable

    mesh = _mesh(spec)
    cfg = LMConfig(**cfg)
    tx = Recording(AdamW(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
                   if adamw is None else AdamW(weight_decay=0.01, **adamw))
    whole = trainable(params_from_jax(cfg, params, device="cpu",
                                      dtype=torch.float32))
    state = shard_state(
        TrainState(step=0, params=whole, opt_state=tx.init(whole), tx=tx,
                   apply_fn=build_lm(cfg)), mesh)
    result = {"rank": mesh.rank, "coords": mesh.coords,
              "shards": {p: _np(t) for p, t in flatten(state.params)}}
    if forward_tokens is not None:
        seg = (None if forward_segment_ids is None
               else torch.from_numpy(forward_segment_ids))
        with torch.no_grad():
            out, sown = state.apply_fn(state.params, torch.from_numpy(
                forward_tokens), seg, return_intermediates=True)
        result["logits"] = _np(out)
        result["cols"] = mesh.slice("sp", forward_tokens.shape[1]).start
        result["sown"] = {blk: {k: _np(v) for k, v in vals.items()
                                if k in ("moe_aux", "moe_expert_load")}
                          for blk, vals in sown.items()}
    if step:
        batch = {"tokens": torch.from_numpy(tokens)}
        if segment_ids is not None:
            batch["segment_ids"] = torch.from_numpy(segment_ids)
        count = WholeCount(fsdp)
        try:
            state, metrics = make_lm_train_step(mesh, cfg=cfg)(state, batch)
        finally:
            count.close()
        result["whole_peak"], result["gathers"] = count.peak, count.gathers
        paths = [p for p, _ in flatten(state.params)]
        result["loss"] = float(metrics["loss"])
        result["grads"] = _whole_grads(mesh, tx, paths,
                                       state.placements["params"])
        result["params"] = _whole(gather_state(state).params)
    return result


def _resnet_state(variables, mesh=None):
    import torch

    from kubeflow_tpu_torch.models import (
        make_optimizer,
        resnet18,
        shard_state,
        train_state_from_jax,
    )

    model = resnet18(num_classes=8, width=8, dtype=torch.float32)
    state_np = types.SimpleNamespace(
        step=0, params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=(None, (types.SimpleNamespace(trace=variables["trace"]),
                          None)))
    state = train_state_from_jax(model, state_np, device="cpu",
                                 tx=Recording(make_optimizer()))
    return state if mesh is None else shard_state(state, mesh)


def case_resnet(spec, variables, images, labels, meshless=False):
    """One resnet18 step on a mesh from the reference's variables: loss,
    accuracy, the whole gradients, parameters, ``batch_stats`` and trace
    after it, and the most fsdp-gathered weights alive at once in the
    step (:class:`WholeCount`); with ``meshless`` also the port's
    one-device step on the whole batch."""
    import torch

    from kubeflow_tpu_torch.models import gather_state, make_train_step
    from kubeflow_tpu_torch.models.optim import flatten
    from kubeflow_tpu_torch.parallel import fsdp

    mesh = _mesh(spec)
    batch = {"image": torch.from_numpy(images),
             "label": torch.from_numpy(labels)}
    state = _resnet_state(variables, mesh)
    tx = state.tx
    count = WholeCount(fsdp)
    try:
        state, metrics = make_train_step(mesh)(state, batch)
    finally:
        count.close()
    paths = [p for p, _ in flatten(state.params)]
    whole = gather_state(state)

    def record(state, metrics, grads):
        return {"loss": float(metrics["loss"]),
                "accuracy": float(metrics["accuracy"]),
                "grads": grads, "params": _whole(state.params),
                "batch_stats": _whole(state.batch_stats),
                "trace": _whole(state.opt_state[1][0].trace)}

    result = {"mesh": record(whole, metrics, _whole_grads(
        mesh, tx, paths, state.placements["params"])),
        "whole_peak": count.peak, "gathers": count.gathers,
        "placements": state.placements["params"]}
    if meshless:
        plain = _resnet_state(variables)
        plain, m = make_train_step()(plain, batch)
        result["meshless"] = record(plain, m, dict(zip(paths, (
            _np(g) for g in plain.tx.grads))))
    return result


def case_batch_norm(spec, x, g, scale, bias, residual=None, relu=True):
    """One BatchNorm (the plain twin: CPU tensors) over this rank's rows
    of the whole batch ``x``, its moments and backward sums taken over
    the (dp, fsdp) group: the output, the running averages and every
    gradient (this rank's own scale and bias sums)."""
    import torch

    from kubeflow_tpu_torch.ops.batch_norm import batch_norm_train

    mesh = _mesh(spec)
    rows = mesh.slice(("dp", "fsdp"), x.shape[0])
    c = x.shape[1]
    inputs = [torch.from_numpy(a[rows] if a.ndim == 4 else a)
              .requires_grad_() for a in (x, scale, bias)]
    res = None
    if residual is not None:
        res = torch.from_numpy(residual[rows]).requires_grad_()
        inputs.append(res)
    out, mean, var = batch_norm_train(
        inputs[0], inputs[1], inputs[2], torch.zeros(c), torch.ones(c),
        mesh.group(("dp", "fsdp")), relu, res)
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(g[rows]))
    return {"rows": (rows.start, rows.stop), "out": _np(out),
            "mean": _np(mean), "var": _np(var),
            **{k: _np(t) for k, t in zip(("dx", "dscale", "dbias", "dres"),
                                         grads)}}


# ------------------------------------------------- checkpoints on a mesh


def _lm_on(mesh, cfg, seed):
    """The LM's train state from ``seed`` on ``mesh`` (None: meshless,
    on the CPU)."""
    from kubeflow_tpu_torch.models import LMConfig, build_lm, create_lm_state

    return create_lm_state(build_lm(LMConfig(**cfg), mesh), seed=seed,
                           mesh=mesh, device="cpu")


def _state_np(state) -> dict:
    """Every array field of a state, whole, as numpy by keystr (bf16
    widened exactly): gathered first when the state is on a mesh."""
    import torch

    from kubeflow_tpu_torch.models import checkpoint as ckpt
    from kubeflow_tpu_torch.models import gather_state

    whole = state if state.mesh is None else gather_state(state)
    out = {}
    for key, leaf in ckpt._flatten_keys(ckpt._arrays_only(whole)):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().float().numpy().copy()
        out[key] = np.asarray(leaf)
    return out


def _sharded(state) -> int:
    """Leaves that really shard on the state's mesh (an axis of size > 1
    in their placement), parameters and moments alike."""
    mesh = state.mesh
    return sum(1 for group in state.placements.values()
               for placement in group.values()
               if any(a is not None and mesh.size(a) > 1 for a in placement))


def _manager(directory, mesh, **kw):
    from kubeflow_tpu_torch.models.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.parallel import AXES

    return CheckpointManager(directory, process_id=mesh.rank,
                             process_count=mesh.size(AXES),
                             fingerprint={"mesh": list(mesh.spec.shape)},
                             **kw)


def case_ckpt_save(root, dirs, spec, cfg, tokens):
    """One LM step on a mesh of the world, then one save of step 10 into
    each of ``dirs`` (a directory per restore that follows, so each has
    its own agreement keys): the whole state, the bytes this rank wrote,
    one copy's bytes, and how many leaves shard."""
    import torch

    from kubeflow_tpu_torch.models import LMConfig, make_lm_train_step

    mesh = _mesh(spec)
    state = _lm_on(mesh, cfg, 0)
    state, _ = make_lm_train_step(mesh, cfg=LMConfig(**cfg))(
        state, {"tokens": torch.from_numpy(tokens)})
    for name in dirs:
        _manager(os.path.join(root, name), mesh).save(10, state)
    whole = _state_np(state)
    wrote = {name: os.path.getsize(os.path.join(
        root, name, "10", f"shard-{mesh.rank:05d}.bin")) for name in dirs}
    # One copy of the state: mu is bf16, 2 bytes an element.
    itemsize = {key: (2 if key.startswith("['opt_state'][0].mu") else
                      whole[key].dtype.itemsize) for key in whole}
    return {"state": whole, "wrote": wrote, "sharded": _sharded(state),
            "copy_bytes": sum(whole[k].size * itemsize[k] for k in whole)}


def case_ckpt_restore(directory, spec, cfg, ranks=None, tokens=None):
    """Restore ``directory``'s newest step onto a mesh of ``ranks`` (all:
    the world) through the manager, into a template from another seed:
    the whole state, the outcome, and with ``tokens`` one step on."""
    import torch

    from kubeflow_tpu_torch.models import LMConfig, make_lm_train_step
    from kubeflow_tpu_torch.models.checkpoint import CheckpointMetrics
    from kubeflow_tpu_torch.parallel import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(**spec), device="cpu", ranks=ranks)
    if mesh is None:
        return {"member": False}
    metrics = CheckpointMetrics()
    manager = _manager(directory, mesh, metrics=metrics)
    like = _lm_on(mesh, cfg, 1)
    restored, step = manager.restore_latest_valid(like)
    out = {"member": True, "step": step, "state": _state_np(restored),
           "restore_total": dict(metrics.restore_total),
           "last_restore": manager.last_restore,
           "sharded": _sharded(restored),
           "shapes_kept": all(
               tuple(a.shape) == tuple(b.shape) for (_, a), (_, b) in zip(
                   _flat_state(restored), _flat_state(like)))}
    if tokens is not None:
        restored, metrics = make_lm_train_step(mesh, cfg=LMConfig(**cfg))(
            restored, {"tokens": torch.from_numpy(tokens)})
        out.update(step_after=restored.step, loss=float(metrics["loss"]))
    return out


def _flat_state(state):
    from kubeflow_tpu_torch.models import checkpoint as ckpt

    return ckpt._flatten_keys(ckpt._arrays_only(state))


def case_ckpt_refuse(directory, spec, cfg):
    """A template of another width on the mesh: the restore refuses it."""
    from kubeflow_tpu_torch.models.checkpoint import CheckpointManager

    mesh = _mesh(spec)
    wrong = _lm_on(mesh, {**cfg, "dim": 2 * cfg["dim"]}, 1)
    try:
        CheckpointManager(directory).restore(10, wrong)
    except ValueError as exc:
        return {"raised": "ValueError", "message": str(exc)}
    return {"raised": None}


def case_ckpt_whole_and_onto(directory, spec, cfg, tokens):
    """``restore_checkpoint`` of a mesh checkpoint into a whole template
    (every leaf whole on every rank), and onto a mesh of another shape
    from that whole template, ``tp_rules`` left out (the LM's layout
    comes from its model; other rules are refused). Then one step on the
    mesh from that restore against the meshless step from the whole one,
    and ``run_with_checkpointing(mesh=)`` from a whole template (no
    ``tp_rules`` either) resuming the same step and taking it."""
    import torch

    from kubeflow_tpu_torch.models import LMConfig, make_lm_train_step
    from kubeflow_tpu_torch.models.checkpoint import restore_checkpoint
    from kubeflow_tpu_torch.models.train import run_with_checkpointing

    whole = restore_checkpoint(directory, _lm_on(None, cfg, 1))
    mesh = _mesh(spec)
    onto = restore_checkpoint(directory, _lm_on(None, cfg, 2), mesh=mesh)
    out = {"whole": _state_np(whole), "onto": _state_np(onto),
           "onto_mesh": onto.mesh is mesh, "sharded": _sharded(onto),
           "q_proj": onto.placements["params"]["block_0/q_proj/kernel"],
           "apply_fn_mesh": onto.apply_fn.mesh is mesh}
    try:
        restore_checkpoint(directory, _lm_on(None, cfg, 2), mesh=mesh,
                           tp_rules={})
        out["other_rules"] = None
    except ValueError:
        out["other_rules"] = "ValueError"
    batch = {"tokens": torch.from_numpy(tokens)}
    step = make_lm_train_step(mesh, cfg=LMConfig(**cfg))
    onto, metrics = step(onto, batch)
    _, plain = make_lm_train_step(None, cfg=LMConfig(**cfg))(whole, batch)
    looped, report = run_with_checkpointing(
        step, _lm_on(None, cfg, 3), [batch], _manager(directory, mesh),
        mesh=mesh, install_signal_handler=False)
    out.update(loss=float(metrics["loss"]), plain_loss=float(plain["loss"]),
               stepped=_state_np(onto), looped=_state_np(looped),
               report=vars(report))
    return out


def case_ckpt_two_process(directory):
    """The reference's two-process restore on ranks 0 and 1: saved under
    a pure-dp layout, restored under an fsdp re-layout, each rank
    reading only its new region."""
    import torch

    from kubeflow_tpu_torch.models.checkpoint import CheckpointMetrics
    from kubeflow_tpu_torch.parallel import MeshSpec, Sharding, make_mesh

    mesh_a = make_mesh(MeshSpec(dp=-1), device="cpu", ranks=[0, 1])
    mesh_b = make_mesh(MeshSpec(dp=1, fsdp=2), device="cpu", ranks=[0, 1])
    if mesh_a is None:
        return {"member": False}
    values = np.arange(2 * 4 * 8, dtype=np.float32).reshape(-1, 8)
    put = Sharding(mesh_a, ("dp", None))
    rows = slice(*put.region(values.shape)[0])
    state = {"w": torch.from_numpy(values[rows]),
             "m": torch.from_numpy(values[rows] * 0.5), "step": np.int32(5)}
    _manager(directory, mesh_a).save(5, state, placements={
        "w": put, "m": put, "step": Sharding(mesh_a, ())})
    metrics = CheckpointMetrics()
    manager = _manager(directory, mesh_b, metrics=metrics)
    like = {"w": np.zeros_like(values), "m": np.zeros_like(values),
            "step": np.int32(0)}
    get = Sharding(mesh_b, (None, "fsdp"))
    restored, step = manager.restore_latest_valid(like, {
        "w": get, "m": get, "step": Sharding(mesh_b, ())})
    return {"member": True, "step": step, "region": get.region(values.shape),
            "w": np.asarray(restored["w"]), "m": np.asarray(restored["m"]),
            "restored_step": int(restored["step"]),
            "cross": manager.last_restore["cross_topology"],
            "restore_total": dict(metrics.restore_total)}


def case_ckpt_loop(root, spec, cfg, batches, ranks=None, seed=0):
    """``run_with_checkpointing(mesh=)`` on a mesh of ``ranks`` over
    ``batches`` (token arrays), saving every 2 steps under ``root``."""
    import torch

    from kubeflow_tpu_torch.models import LMConfig, make_lm_train_step
    from kubeflow_tpu_torch.models.train import run_with_checkpointing
    from kubeflow_tpu_torch.parallel import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(**spec), device="cpu", ranks=ranks)
    if mesh is None:
        return {"member": False}
    manager = _manager(root, mesh)
    state, report = run_with_checkpointing(
        make_lm_train_step(mesh, cfg=LMConfig(**cfg)), _lm_on(mesh, cfg, seed),
        [{"tokens": torch.from_numpy(t)} for t in batches], manager,
        save_every_steps=2, mesh=mesh, install_signal_handler=False)
    return {"member": True, "report": vars(report),
            "latest": manager.latest_committed_step(),
            "fingerprint": manager.step_fingerprint(
                manager.latest_committed_step())}


def case_goodput_reshard(root, spec_a, spec_b, ranks_b, cfg, batches_a,
                         batches_b):
    """The reference's goodput-across-reshard scenario: one
    ``GoodputMeter`` through two ``run_with_checkpointing`` segments,
    the first on ``spec_a`` over the world saving every 2 steps, the
    second on the refactored ``spec_b`` over ``ranks_b`` resuming from
    the first's checkpoint. Returns the reports and the meter's
    summary."""
    import torch

    from kubeflow_tpu_torch.models import LMConfig, make_lm_train_step
    from kubeflow_tpu_torch.models.train import run_with_checkpointing
    from kubeflow_tpu_torch.obs.telemetry import GoodputMeter
    from kubeflow_tpu_torch.parallel import MeshSpec, make_mesh

    goodput = GoodputMeter()
    reports = []
    for spec, ranks, batches, seed in ((spec_a, None, batches_a, 0),
                                       (spec_b, ranks_b, batches_b, 2)):
        mesh = make_mesh(MeshSpec(**spec), device="cpu", ranks=ranks)
        if mesh is None:
            break
        _, report = run_with_checkpointing(
            make_lm_train_step(mesh, cfg=LMConfig(**cfg)),
            _lm_on(mesh, cfg, seed),
            [{"tokens": torch.from_numpy(t)} for t in batches],
            _manager(root, mesh), save_every_steps=2, mesh=mesh,
            install_signal_handler=False, goodput=goodput)
        reports.append(vars(report))
    return {"reports": reports, "goodput": goodput.summary(),
            "ratio": goodput.goodput_ratio()}


def case_ckpt_sigterm(root, spec, cfg, batches, stop_after):
    """The loop on a mesh of the world, preempted: process 0 takes a
    SIGTERM after ``stop_after`` steps, every rank stops at the agreed
    boundary and saves; a fresh template resumes there over the rest of
    the batches. Returns both runs' reports and the resumed state and an
    uninterrupted run's, whole."""
    import signal

    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import LMConfig, make_lm_train_step
    from kubeflow_tpu_torch.models.train import (
        realign_batches,
        run_with_checkpointing,
    )

    mesh = _mesh(spec)
    step = make_lm_train_step(mesh, cfg=LMConfig(**cfg))
    data = [{"tokens": torch.from_numpy(t)} for t in batches]
    straight = _lm_on(mesh, cfg, 0)
    for batch in data:
        straight, _ = step(straight, batch)

    def preempting(state, batch):
        state, metrics = step(state, batch)
        if dist.get_rank() == 0 and state.step == stop_after:
            os.kill(os.getpid(), signal.SIGTERM)
        return state, metrics

    _, first = run_with_checkpointing(preempting, _lm_on(mesh, cfg, 0),
                                      data, _manager(root, mesh),
                                      mesh=mesh)
    resumed, second = run_with_checkpointing(
        step, _lm_on(mesh, cfg, 5),
        realign_batches(data, first.final_step), _manager(root, mesh),
        mesh=mesh)
    return {"first": vars(first), "second": vars(second),
            "resumed": _state_np(resumed), "straight": _state_np(straight)}


# ------------------------------------------------------------- pipelines


def _toy_stage(kind: str, mesh):
    """The reference tests' toy stages: ``affine`` (h @ p + 1), ``tanh``
    (tanh(h @ p)), ``chunk`` (tanh(h @ p_i) over a chunk's layers) and
    ``sp_hop`` (``chunk`` plus half of the sp neighbour's h, a rotation
    on the datapath)."""
    import torch

    from kubeflow_tpu_torch.parallel.collectives import Rotate

    def chunk(p, h):
        for i in range(p.shape[0]):
            h = torch.tanh(h @ p[i])
        return h

    def sp_hop(p, h):
        for i in range(p.shape[0]):
            h = torch.tanh(h @ p[i] + 0.5 * Rotate.apply(h, mesh.group("sp")))
        return h

    return {"affine": lambda p, h: h @ p + 1.0,
            "tanh": lambda p, h: torch.tanh(h @ p),
            "chunk": chunk, "sp_hop": sp_hop}[kind]


def _stage_block(mesh, w, layout: str, virtual: int = 1):
    """This rank's (1, ...) block of the whole stack ``w`` (numpy) in the
    engine's layout: ``plain`` (w is (P, ...) already), ``stack``
    (stage_stack) or ``interleaved`` (stage_stack_interleaved)."""
    import torch

    from kubeflow_tpu_torch.parallel import (
        stage_stack,
        stage_stack_interleaved,
    )

    whole = torch.from_numpy(np.array(w))
    p, d = mesh.shape["pp"], mesh.index("pp")
    if layout == "stack":
        whole = stage_stack(whole, p)
    elif layout == "interleaved":
        whole = stage_stack_interleaved(whole, p, virtual)
    return whole[d:d + 1].clone()


class AllocatorPeak:
    """The CPU allocator's high-water mark over a region, in bytes above
    what it held when the region began: every storage made and freed in
    it, whoever holds it (autograd's saved tensors, a schedule's own
    buffers, the results), from the profiler's allocation events."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU],
                             profile_memory=True)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        events, stack = [], list(
            self._prof.profiler.kineto_results.experimental_event_tree())
        while stack:
            event = stack.pop()
            stack.extend(event.children)
            if hasattr(event.extra_fields, "alloc_size"):
                events.append((event.start_time_ns,
                               event.extra_fields.alloc_size))
        level = self.peak = 0
        for _, size in sorted(events):
            level += size
            self.peak = max(self.peak, level)


def case_pp_engine(spec, engine, stage, w, x, num_microbatches,
                   layout="plain", virtual=1, output="replicated",
                   grad=False, sp_rows=False, sum_sp=False, remat=False):
    """One toy pipeline (``engine``: a ``parallel`` engine's name) on a
    mesh of ``spec``: this rank's output (its microbatch shard with
    sharded output) and, with ``grad``, the gradients of sum(y^2) (the
    ranks' losses add up to the whole output's) for its stage block and
    for x. ``sp_rows``: this rank holds its sp block of every
    microbatch's rows (the reference's activation_spec P(None, "sp")),
    else all of x. ``sum_sp``: the stage gradient summed over sp, the
    caller's data-axis reduction."""
    import torch

    from kubeflow_tpu_torch import parallel
    from kubeflow_tpu_torch.parallel.collectives import all_reduce

    mesh = _mesh(spec)
    kw = dict(num_microbatches=num_microbatches, output=output)
    if engine.startswith("interleaved"):
        kw["virtual_stages"] = virtual
    if remat:
        kw["remat"] = True
    run = getattr(parallel, engine)(_toy_stage(stage, mesh), mesh, **kw)
    block = _stage_block(mesh, w, layout, virtual).requires_grad_(grad)
    xs = np.asarray(x)
    if sp_rows:
        xm = xs.reshape(num_microbatches, -1, *xs.shape[1:])
        part = xm.shape[1] // mesh.size("sp")
        j = mesh.index("sp")
        xs = xm[:, j * part:(j + 1) * part].reshape(-1, *xs.shape[1:])
    x_t = torch.from_numpy(np.array(xs)).requires_grad_(grad)
    y = run(block, x_t)
    out = {"y": _np(y), "pp": mesh.index("pp"), "sp": mesh.index("sp"),
           "rows": y.shape[0]}
    if grad:
        g_block, g_x = torch.autograd.grad((y ** 2).sum(), [block, x_t])
        if sum_sp:
            g_block = all_reduce(g_block.clone(), mesh.group("sp"))
        out.update(g_block=_np(g_block[0]), g_x=_np(g_x))
    return out


def case_pp_saved(spec, w, rows, counts):
    """Temporary bytes of one interleaved pipeline step (V=2, the
    ``chunk`` stage, forward and backward) of ``rows`` rows a
    microbatch, per engine and microbatch count (``counts`` = [(engine,
    M), ...]): the step's allocator high-water mark above its arguments,
    less its results (the output and the gradients of the stage block
    and of x), as compiled temp bytes count."""
    import torch

    from kubeflow_tpu_torch import parallel

    mesh = _mesh(spec)
    out = {}
    for engine, m in counts:
        run = getattr(parallel, engine)(_toy_stage("chunk", mesh), mesh,
                                        num_microbatches=m, virtual_stages=2)
        block = _stage_block(mesh, w, "interleaved", 2).requires_grad_(True)
        x = torch.zeros((m * rows, np.asarray(w).shape[-1]),
                        requires_grad=True)
        cot = torch.ones_like(x)
        with AllocatorPeak() as step:
            y = run(block, x)
            grads = torch.autograd.grad(y, [block, x], cot)
            results = sum(t.untyped_storage().nbytes() for t in (y, *grads))
            del y, grads
        out[f"{engine}:{m}"] = step.peak - results
    return out


def _pp_model(mesh, cfg, model):
    from kubeflow_tpu_torch.models import LMConfig, PipelinedLM

    return PipelinedLM(LMConfig(**cfg), mesh, use_flash=False, **model)


def _pp_state(mesh, cfg, model, params, tx):
    """The pipelined model's state on ``mesh`` from the reference's
    whole parameters (numpy), each rank keeping its shards."""
    import torch

    from kubeflow_tpu_torch.models import (
        LMConfig,
        TrainState,
        params_from_jax,
        shard_state,
    )
    from kubeflow_tpu_torch.models.optim import trainable

    pmodel = _pp_model(mesh, cfg, model)
    whole = trainable(params_from_jax(LMConfig(**cfg), params, device="cpu",
                                      dtype=torch.float32))
    return pmodel, shard_state(TrainState(
        step=0, params=whole, opt_state=tx.init(whole), tx=tx,
        apply_fn=pmodel), mesh)


def case_pp_lm(spec, cfg, model, params, tokens, segment_ids=None,
               forward=True, steps=1, adamw=None, sequential=False,
               unpacked=False, window_off=False):
    """The pipelined LM (``model``: PipelinedLM's keywords) on a mesh of
    ``spec`` from the reference's parameters: this rank's shards and
    their placements; with ``forward`` its output at its rows (global
    row and column ranges) — with ``unpacked`` also without the segment
    ids, with ``window_off`` also of the config without its window, on
    the same parameters — and with ``sequential`` (rank 0) the port's
    ``sequential_apply`` on the whole batch; then ``steps`` train steps
    on the whole batch: their losses, and after the first the whole
    gradients and parameters. ``adamw``: AdamW's ``lr`` and ``eps`` with
    f32 moments, else the reference LM's."""
    import torch

    from kubeflow_tpu_torch.models import (
        AdamW,
        gather_state,
        make_pp_lm_train_step,
    )
    from kubeflow_tpu_torch.models.optim import flatten

    mesh = _mesh(spec)
    tx = Recording(AdamW(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
                   if adamw is None else AdamW(weight_decay=0.01, **adamw))
    pmodel, state = _pp_state(mesh, cfg, model, params, tx)
    result = {"rank": mesh.rank, "coords": mesh.coords,
              "shards": {p: _np(t) for p, t in flatten(state.params)},
              "placements": dict(state.placements["params"])}
    tok = torch.from_numpy(np.asarray(tokens))
    seg = None if segment_ids is None else torch.from_numpy(
        np.asarray(segment_ids))
    if forward:
        rows = mesh.slice(("dp", "fsdp"), tok.shape[0])
        cols = mesh.slice("sp", tok.shape[1])
        out = pmodel.output_rows(rows.stop - rows.start)
        local_seg = None if seg is None else seg[rows]
        with torch.no_grad():
            result["logits"] = _np(pmodel(state.params, tok[rows],
                                          local_seg))
            if unpacked:
                result["logits_unpacked"] = _np(pmodel(state.params,
                                                       tok[rows]))
            if window_off:
                full = _pp_model(mesh, {**cfg, "attn_window": None}, model)
                result["logits_full"] = _np(full(state.params, tok[rows],
                                                 local_seg))
        result["row_range"] = (rows.start + out.start, rows.start + out.stop)
        result["col_range"] = (cols.start, cols.stop)
        if sequential:
            whole = gather_state(state).params   # a collective
        if sequential and mesh.rank == 0:
            with torch.no_grad():
                result["sequential"] = _np(pmodel.sequential_apply(
                    whole, tok, seg))
    batch = {"tokens": tok}
    if seg is not None:
        batch["segment_ids"] = seg
    step = make_pp_lm_train_step(pmodel)
    losses = []
    for i in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            paths = [p for p, _ in flatten(state.params)]
            result["grads"] = _whole_grads(mesh, tx, paths,
                                           state.placements["params"])
            result["params"] = _whole(gather_state(state).params)
    result["losses"] = losses
    return result


def case_pp_born(spec, cfg, model, tokens, steps=2):
    """``create_pp_lm_state`` on a mesh of ``spec``: each rank's shard
    shapes and placements, and ``steps`` steps on one batch (losses, the
    state's step)."""
    import torch

    from kubeflow_tpu_torch.models import (
        create_pp_lm_state,
        make_pp_lm_train_step,
    )
    from kubeflow_tpu_torch.models.optim import flatten

    mesh = _mesh(spec)
    pmodel = _pp_model(mesh, cfg, model)
    state = create_pp_lm_state(pmodel, seed=1)
    out = {"placements": dict(state.placements["params"]),
           "shapes": {p: tuple(t.shape) for p, t in flatten(state.params)},
           "apply_fn": type(state.apply_fn).__name__}
    step = make_pp_lm_train_step(pmodel)
    batch = {"tokens": torch.from_numpy(np.asarray(tokens))}
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    out.update(losses=losses, step=state.step)
    return out


def case_pp_ckpt(root, spec, cfg, model, tokens, jax_dir=None):
    """TestPipelinedCheckpoint on a mesh of ``spec``: a pipelined state
    from seed 0 stepped once and saved (each rank its first-replica
    blocks) under ``root/port``, restored through ``restore_checkpoint``
    into a template from seed 1 on the same mesh (the state whole, the
    q_proj placement, one step on), and with ``jax_dir`` the reference's
    pipelined checkpoint restored onto this mesh (whole)."""
    import torch

    from kubeflow_tpu_torch.models import (
        create_pp_lm_state,
        make_pp_lm_train_step,
    )
    from kubeflow_tpu_torch.models.checkpoint import restore_checkpoint

    mesh = _mesh(spec)
    pmodel = _pp_model(mesh, cfg, model)
    step = make_pp_lm_train_step(pmodel)
    batch = {"tokens": torch.from_numpy(np.asarray(tokens))}
    state, _ = step(create_pp_lm_state(pmodel, seed=0), batch)
    _manager(os.path.join(root, "port"), mesh).save(state.step, state)
    saved = _state_np(state)
    restored = restore_checkpoint(os.path.join(root, "port"),
                                  create_pp_lm_state(pmodel, seed=1),
                                  mesh=mesh)
    out = {"saved": saved, "restored": _state_np(restored),
           "step": restored.step, "same_model": restored.apply_fn == pmodel,
           "q_proj": restored.placements["params"]["blocks/q_proj/kernel"],
           "q_shape": tuple(restored.params["blocks"]["q_proj"][
               "kernel"].shape)}
    restored, metrics = step(restored, batch)
    out["loss_on"] = float(metrics["loss"])
    if jax_dir is not None:
        from_jax = restore_checkpoint(jax_dir,
                                      create_pp_lm_state(pmodel, seed=2),
                                      mesh=mesh)
        out["from_jax"] = _state_np(from_jax)
        out["from_jax_step"] = from_jax.step
    return out


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


def main(workdir: str, rank: int, world: int, port: int) -> int:
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import (
        initialize_from_env,
        slice_env_for_rank,
    )

    torch.set_num_threads(1)
    env = slice_env_for_rank("nb", "user-ns", rank, world)
    env["KFT_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    initialize_from_env(env, device="cpu")
    with open(Path(workdir) / "tasks.pkl", "rb") as fh:
        tasks = pickle.load(fh)
    results = {}
    for name, inputs in tasks:
        if name == "world":
            inputs = {"env": env}
        try:
            results[name] = CASES[name.split(":")[0]](**inputs)
        # The traceback goes to the parent, which fails the case's tests.
        # analysis: allow[py-broad-except]
        except Exception:
            results[name] = {"error": traceback.format_exc()}
    with open(Path(workdir) / f"out_{rank}.pkl", "wb") as fh:
        pickle.dump(results, fh)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                  int(sys.argv[4])))

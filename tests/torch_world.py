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


def case_lm(spec, cfg, params, tokens, segment_ids=None, forward_tokens=None,
            forward_segment_ids=None, step=True):
    """The LM on a mesh from the reference's parameters (numpy): this
    rank's parameter shards, the model's output at its rows (every row of
    ``forward_tokens``) and sp columns, and one train step on the whole
    batch: its loss, the whole gradients and parameters after it."""
    import torch

    from kubeflow_tpu_torch.models import (
        AdamW,
        LMConfig,
        LM_TP_RULES,
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
    tx = Recording(AdamW(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16))
    whole = trainable(params_from_jax(cfg, params, device="cpu",
                                      dtype=torch.float32))
    state = shard_state(
        TrainState(step=0, params=whole, opt_state=tx.init(whole), tx=tx,
                   apply_fn=build_lm(cfg)), mesh, tp_rules=LM_TP_RULES)
    result = {"rank": mesh.rank, "coords": mesh.coords,
              "shards": {p: _np(t) for p, t in flatten(state.params)}}
    if forward_tokens is not None:
        seg = (None if forward_segment_ids is None
               else torch.from_numpy(forward_segment_ids))
        with torch.no_grad():
            out = state.apply_fn(state.params, torch.from_numpy(
                forward_tokens), seg)
        result["logits"] = _np(out)
        result["cols"] = mesh.slice("sp", forward_tokens.shape[1]).start
    if step:
        batch = {"tokens": torch.from_numpy(tokens)}
        if segment_ids is not None:
            batch["segment_ids"] = torch.from_numpy(segment_ids)
        state, metrics = make_lm_train_step(mesh, cfg=cfg)(state, batch)
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
    after it; with ``meshless`` also the port's one-device step on the
    whole batch."""
    import torch

    from kubeflow_tpu_torch.models import gather_state, make_train_step
    from kubeflow_tpu_torch.models.optim import flatten

    mesh = _mesh(spec)
    batch = {"image": torch.from_numpy(images),
             "label": torch.from_numpy(labels)}
    state = _resnet_state(variables, mesh)
    tx = state.tx
    state, metrics = make_train_step(mesh)(state, batch)
    paths = [p for p, _ in flatten(state.params)]
    whole = gather_state(state)

    def record(state, metrics, grads):
        return {"loss": float(metrics["loss"]),
                "accuracy": float(metrics["accuracy"]),
                "grads": grads, "params": _whole(state.params),
                "batch_stats": _whole(state.batch_stats),
                "trace": _whole(state.opt_state[1][0].trace)}

    result = {"mesh": record(whole, metrics, _whole_grads(
        mesh, tx, paths, state.placements["params"]))}
    if meshless:
        plain = _resnet_state(variables)
        plain, m = make_train_step()(plain, batch)
        result["meshless"] = record(plain, m, dict(zip(paths, (
            _np(g) for g in plain.tx.grads))))
    return result


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

"""Pipeline parallelism: GPipe and 1F1B schedules over the ``pp`` axis.

The counterpart of ``kubeflow_tpu/parallel/pipeline.py``, with its public
contract: :func:`pipeline_ticks`, :func:`gpipe`, :func:`one_f_one_b`,
:func:`interleaved_gpipe`, :func:`interleaved_one_f_one_b`,
:func:`stage_stack` and :func:`stage_stack_interleaved`, their argument
lists, the ``(B, ...) <-> (M, mb, ...)`` wrapper with the side input
``extra``, and the two output modes.

The reference runs its schedule inside ``jax.shard_map`` manual over
``pp``; here each rank runs its stage. A rank's ``stage_params`` are its
``pp`` block of the stacked leaves: every leaf has a leading stage dim of
size 1 (its row of :func:`stage_stack`'s ``(P, ...)``, or of
:func:`stage_stack_interleaved`'s ``(P, V, ...)``), and every other
tensor is this rank's local block. ``activation_spec``, ``extra_spec``
and ``extra_manual_axes`` (and ``uniform_collectives``, below) are
accepted for parity with the reference's argument lists and have no
effect: only the rule that dim 0, the microbatch axis, is unsharded is
checked. Each tick is a Python step: a rank knows which unit it runs,
so it runs no stage on a bubble and posts no hop on a dead edge, both
ends of every edge reading the same static schedule.

Two schedules, one contract:

- :func:`gpipe` — M microbatches through P stages in M + P - 1 ticks;
  the backward is autograd through the tick chain, as the reference's is
  AD of its scan: live microbatch state is O(M). ``remat=True`` wraps the
  stage in ``torch.utils.checkpoint`` (``use_reentrant=False``, early
  stop off, so a stage with collectives recomputes them whole).
  :func:`interleaved_gpipe` runs V chunks a rank round robin.
- :func:`one_f_one_b` — PipeDream-flush: the forward runs without a
  graph, and a ``torch.autograd.Function`` owns the backward, scheduled
  by hand from static slot tables (``_1f1b_tables``, or
  ``parallel.schedule1f1b.build_schedule`` with virtual stages): each
  slot runs one forward recompute or one backward of a stage from a
  buffer of stage inputs, parameter gradients accumulated. Stage
  internals are recomputed, never stored: O(P) live microbatch state
  (O(P·V) with virtual stages) however large M grows.

Autograd and the hops. Autograd runs a node only where the loss reaches
it, and on a rank most hops' results feed nothing the rank keeps (stage
0 discards what it receives; a send's gradient comes back through the
reverse hop). So every hop result (:class:`~kubeflow_tpu_torch.parallel.
collectives.Hop`) is tied into the pipeline's output
(:class:`~kubeflow_tpu_torch.parallel.collectives.Tie`, as
``ops/ring.py`` ties the ring's last rotation), and a hop that
only receives carries an ``anchor`` (an empty view of a parameter) so
that its node exists: every rank then runs every reverse hop, in the
reverse of the forward's order. The microbatch input enters through
``CopyToGroup`` over pp (tied too), so its gradient, which stage 0
alone computes, comes out whole on every rank, as the reference's
replicated input's cotangent does.

Uniform collectives. The reference's ``uniform_collectives`` runs one
vjp on every device every tick, because XLA's rendezvous joined
branch-divergent collectives across ops. Here a stage's collectives run
on the groups of its own ranks (sp, tp, fsdp), all of which sit at the
same pp index and so run the same unit in every slot, and the pp hops
run first in each slot on every rank: every group sees one order by
construction. The argument is kept and both values run that schedule.

The reference's ``_collective_seq`` pins collective order on the XLA CPU
runtime, which runs independent collectives in a device-divergent order.
Eager torch issues collectives in program order on every rank, so it has
no counterpart here.

Output modes: ``output="sharded"`` hands back the microbatch dim sharded
over pp by one reduce-scatter of the last stage's buffer (every other
rank contributes zeros); its backward all-gathers the cotangent.
``output="replicated"`` all-reduces the masked buffer: every rank holds
all M microbatches and computes the same loss, so the backward is the
identity (each rank's cotangent is the whole one).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from kubeflow_tpu_torch.parallel.collectives import (
    CopyToGroup,
    Hop,
    ReduceFromGroup,
    ReduceScatterToGroup,
    Tie,
    all_reduce,
    exchange,
)
from kubeflow_tpu_torch.parallel.schedule1f1b import (
    Interleaved1F1B,
    build_schedule,
    check_schedule,
)

# stage_fn(stage_params, x[, extra]) -> y with y.shape == x.shape: one
# pipeline stage (e.g. a loop over its slice of the layer stack).
StageFn = Callable[..., torch.Tensor]


def pipeline_ticks(num_microbatches: int, num_stages: int) -> int:
    """Ticks for one GPipe pass: M + P - 1."""
    return num_microbatches + num_stages - 1


def _validate(act_spec, output: str, num_microbatches: int,
              num_stages: int) -> None:
    """Shared public-contract checks for both schedules."""
    if act_spec and act_spec[0] is not None:
        raise ValueError(
            "activation_spec dim 0 is the microbatch axis and must be "
            f"unsharded, got {act_spec}"
        )
    if output not in ("replicated", "sharded"):
        raise ValueError(f"output must be replicated|sharded, got {output}")
    if output == "sharded" and num_microbatches % num_stages:
        raise ValueError(
            f"sharded output needs num_microbatches={num_microbatches} "
            f"divisible by pp={num_stages}"
        )


def _check_virtual(virtual_stages: int, num_microbatches: int,
                   num_stages: int) -> None:
    if virtual_stages < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {virtual_stages}")
    if num_microbatches % num_stages:
        raise ValueError(
            f"interleaved schedule needs num_microbatches="
            f"{num_microbatches} divisible by pp={num_stages} (groups "
            "of P microbatches tile the V*P-tick cycle)"
        )


def _microbatched(pipeline_fn, num_microbatches: int):
    """Shared (B, ...) <-> (M, mb, ...) wrapper for every schedule.
    ``extra`` (e.g. segment ids for packed batches) microbatches the
    same way and rides NEXT TO the activations — it is indexed per
    microbatch at each stage, never circulated. With sharded output the
    result holds this rank's M / P microbatches: (M / P * mb, ...)."""

    def run(stage_params, x, extra=None):
        if x.shape[0] % num_microbatches:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by "
                f"num_microbatches={num_microbatches}"
            )
        mb = x.shape[0] // num_microbatches
        xm = x.reshape(num_microbatches, mb, *x.shape[1:])
        em = None
        if extra is not None:
            em = extra.reshape(num_microbatches, mb, *extra.shape[1:])
        ym = pipeline_fn(stage_params, xm, em)
        return ym.reshape(ym.shape[0] * ym.shape[1], *ym.shape[2:])

    return run


# ------------------------------------------------------------ trees


def _leaves(tree) -> list:
    """A stage's parameter tree (a tensor, or nested dicts of them) as
    its leaves, dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure over the iterator ``leaves``."""
    if isinstance(tree, dict):
        rebuilt = {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
        return {key: rebuilt[key] for key in tree}
    return next(leaves)


def _map(fn, tree):
    return _rebuild(tree, iter([fn(leaf) for leaf in _leaves(tree)]))


def _own_stage(stage_params):
    """This rank's stage from its block of the stacked leaves (leading
    stage dim 1)."""
    for leaf in _leaves(stage_params):
        if leaf.shape[:1] != (1,):
            raise ValueError(
                "stage_params hold this rank's stage: every leaf's leading "
                "dim is 1 (its pp block of stage_stack's (P, ...)), got "
                f"{tuple(leaf.shape)}")
    return _map(lambda leaf: leaf[0], stage_params)


# ------------------------------------------------------------ schedule


def _unit(t: int, d: int, P: int, V: int, M: int):
    """The unit rank ``d`` runs at tick ``t`` of the forward: (chunk v,
    microbatch m), or None on a bubble. Microbatch j of group g runs
    chunk v on rank d at t = g*V*P + v*P + d + j (V = 1: t = m + d)."""
    u = t - d
    if u < 0:
        return None
    g, w = divmod(u, V * P)
    v, j = divmod(w, P)
    m = g * P + j
    return (v, m) if m < M else None


@functools.lru_cache(maxsize=64)
def _forward_plan(M: int, P: int, V: int) -> tuple:
    """Per tick, per rank: the unit, and whether the hop into the rank
    carries that unit's input (its global stage is not the first). Both
    ends of an edge must agree: the sender's previous unit feeds the
    next global stage exactly when the receiver's unit takes it."""
    C, ticks = V * P, M * V + P - 1
    units = [[_unit(t, d, P, V, M) for d in range(P)] for t in range(ticks)]

    def stage(unit, d):
        return unit[0] * P + d

    recv = [[u is not None and stage(u, d) > 0 for d, u in enumerate(row)]
            for row in units]
    for t in range(1, ticks):
        for d in range(P):
            prev = units[t - 1][d]
            sends = prev is not None and stage(prev, d) < C - 1
            if sends != recv[t][(d + 1) % P]:
                raise AssertionError(
                    f"pipeline plan: edge {d}->{(d + 1) % P} at tick {t} "
                    f"is live on one end only (M={M}, P={P}, V={V})")
    return units, recv


def _stage_call(stage_fn, remat: bool):
    if not remat:
        return stage_fn

    def call(*args):
        from torch.utils.checkpoint import (
            checkpoint,
            set_checkpoint_early_stop,
        )

        # Early stop would end a recompute as soon as its saved tensors
        # are back, which differs by rank when a stage's collectives
        # (the sp ring) follow the last saved tensor on some ranks only.
        with set_checkpoint_early_stop(False):
            return checkpoint(stage_fn, *args, use_reentrant=False)

    return call


def _anchor(params, xm):
    """An empty view of a tensor that requires grad, with a path to the
    parameters, so that a receive-only hop's node exists and runs."""
    for leaf in _leaves(params) + [xm]:
        if leaf.requires_grad:
            return leaf.reshape(-1)[:0]
    return None


def _forward_ticks(stage_fn, params, xm, em, group, idx: int, P: int,
                   V: int, chunked: bool, remat: bool = False):
    """The forward tick loop shared by every schedule (the 1F1B primal
    IS this forward; only backwards differ). ``params``: this rank's
    stage, or with ``chunked`` its (V, ...) chunks. Returns the last
    stage's (M, mb, ...) buffer on the rank that runs it, zeros
    elsewhere (the masked buffer the output modes reduce), with every
    hop tied in."""
    M, C = xm.shape[0], V * P
    units, recv = _forward_plan(M, P, V)
    run = _stage_call(stage_fn, remat)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in _leaves(params) + [xm])
    anchor = _anchor(params, xm) if grad else None
    like = xm[0].detach()
    if P > 1:
        # NCCL: the first batched point-to-point call on a group must
        # involve all its ranks, and a tick's hops involve some.
        all_reduce(xm.new_zeros(1), group)
    source = CopyToGroup.apply(xm, group) if grad and P > 1 else xm
    tied = [source] if source is not xm else []
    outs: dict[int, torch.Tensor] = {}
    prev = None
    for t, row in enumerate(units):
        got = None
        if P > 1 and t > 0:
            sends = recv[t][(idx + 1) % P]
            takes = recv[t][idx]
            if sends or takes:
                got = Hop.apply(prev if sends else None, anchor, like, group,
                                (idx + 1) % P if sends else None,
                                (idx - 1) % P if takes else None)
                if grad:
                    tied.append(got)
        unit = row[idx]
        if unit is None:
            prev = None
            continue
        v, m = unit
        s = v * P + idx
        if s == 0:
            x_in = source[m]
        elif P == 1:
            x_in = prev          # the wrap edge of a ring of one
        else:
            x_in = got
        chunk = _map(lambda leaf: leaf[v], params) if chunked else params
        args = (chunk, x_in) if em is None else (chunk, x_in, em[m])
        prev = out = run(*args)
        if s == C - 1:
            outs[m] = out
    if idx == P - 1:
        outbuf = torch.stack([outs[m] for m in range(M)])
    else:
        outbuf = torch.zeros_like(xm)
    if tied:
        outbuf = Tie.apply(outbuf, *tied)
    return outbuf


def _emit(outbuf, group, output: str):
    """Deliver the masked (M, ...) buffer per the output mode: sharded,
    one reduce-scatter over pp (this rank's M / P microbatches);
    replicated, one all-reduce (all M on every rank)."""
    if output == "sharded":
        return ReduceScatterToGroup.apply(outbuf, 0, group)
    return ReduceFromGroup.apply(outbuf, group)


def _engine(stage_fn, mesh, axis: str, V: int, chunked: bool, remat: bool,
            output: str):
    def pipeline(stage_params, xm, em):
        params = _own_stage(stage_params)
        group = mesh.group(axis)
        outbuf = _forward_ticks(stage_fn, params, xm, em, group,
                                mesh.index(axis), mesh.shape[axis], V,
                                chunked, remat)
        return _emit(outbuf, group, output)

    return pipeline


def gpipe(
    stage_fn: StageFn,
    mesh,
    *,
    num_microbatches: int,
    axis: str = "pp",
    remat: bool = False,
    activation_spec=None,
    extra_spec=None,
    extra_manual_axes: tuple[str, ...] = (),
    output: str = "replicated",
):
    """Wrap ``stage_fn`` into a pipelined pass over the full layer stack.

    Returns ``run(stage_params, x[, extra]) -> y``:

    - ``stage_params``: this rank's block of a tree whose every leaf is
      stacked on a leading stage dim of size P = mesh.shape[axis]: leaf
      shape ``(1, ...)``, its stage's slice.
    - ``x``: this rank's activations ``(B, ...)`` with B divisible by
      ``num_microbatches`` (the same on every pp rank).
    - ``y``: the stack's output. ``output="replicated"`` (default) hands
      back all of ``(B, ...)`` on every stage; ``output="sharded"`` this
      rank's M / P microbatches, ``(B / P, ...)``, so downstream code
      (head, loss) runs on M/P microbatches per stage. Requires
      num_microbatches divisible by P.

    ``extra`` is a per-microbatch SIDE input (e.g. packed-batch segment
    ids), microbatched like x and indexed by each stage at the
    microbatch it is running, never circulated. ``activation_spec``,
    ``extra_spec`` and ``extra_manual_axes``: the reference's, with no
    effect here (module docstring); dim 0 must stay unsharded.

    Differentiable end to end: the backward is autograd through the
    tick chain, cotangents flowing stage to stage through the reverse
    hops; the parameter gradients are this rank's stage's (summing
    over the data axes is the caller's, as the LM step does)."""
    num_stages = mesh.shape[axis]
    act_spec = () if activation_spec is None else activation_spec
    _validate(act_spec, output, num_microbatches, num_stages)
    return _microbatched(
        _engine(stage_fn, mesh, axis, 1, False, remat, output),
        num_microbatches)


def interleaved_gpipe(
    stage_fn: StageFn,
    mesh,
    *,
    num_microbatches: int,
    virtual_stages: int,
    axis: str = "pp",
    remat: bool = False,
    activation_spec=None,
    extra_spec=None,
    extra_manual_axes: tuple[str, ...] = (),
    output: str = "replicated",
):
    """Interleaved (virtual-stage) pipeline forward, Megatron-style:
    every rank holds ``V = virtual_stages`` model CHUNKS laid out round
    robin (rank d owns global stages d, d+P, ..., d+(V-1)P), so one
    microbatch visits each rank V times; the fill/drain bubble stays
    P - 1 ticks (one ring traversal) instead of V*P - 1.

    Microbatch j of group g runs chunk v on rank d at tick
    ``t = g*V*P + v*P + d + j``: each rank does one unit of work per tick
    in [d, d + V*P) per group, consecutive global stages one tick apart
    (rank d -> d+1, the ring's wrap edge carrying chunk boundaries
    P-1 -> 0). Total ticks: M*V + P - 1, requiring M % P == 0.

    ``stage_params`` leaves are this rank's ``(1, V, layers/(V*P), ...)``
    block of :func:`stage_stack_interleaved`; ``stage_fn`` gets one
    chunk. The backward is autograd of the tick chain (like
    :func:`gpipe`); ``remat=True`` recomputes chunk internals."""
    num_stages = mesh.shape[axis]
    _check_virtual(virtual_stages, num_microbatches, num_stages)
    act_spec = () if activation_spec is None else activation_spec
    _validate(act_spec, output, num_microbatches, num_stages)
    return _microbatched(
        _engine(stage_fn, mesh, axis, virtual_stages, True, remat, output),
        num_microbatches)


# ------------------------------------------------------------ 1F1B


def _1f1b_tables(num_microbatches: int, num_stages: int):
    """Static slot tables for the PipeDream-flush schedule. Slot = one
    compute unit (one stage forward OR one stage backward). Derived
    from the canonical timing (stage s, microbatch m):

      F(s, m) = s + m            for m <= P-1-s   (warmup)
                2m + s           otherwise        (1F1B steady state)
      B(s, m) = 2P - 1 + 2m - s                   (B(P-1,m)=F(P-1,m)+1)

    F and B slots are disjoint per stage; the activation for (s, m) is
    PRODUCED at F(s-1, m) and may wait until F(s, m), but never more
    than P microbatches are in flight per stage, so a P-slot circular
    buffer keyed m mod P holds every pending input; the cotangent for
    (s, m) ARRIVES exactly at B(s, m) (no buffering).

    Returns numpy (F_tbl, B_tbl, R_tbl) of shape (T, P) with -1 = idle,
    where R_tbl[t, s] is the microbatch whose activation arrives at
    stage s in slot t (= F_tbl[t-1, s-1]), and T = 2(M + P - 1)."""
    M, Pn = num_microbatches, num_stages
    T = 2 * (M + Pn - 1)
    F = np.full((T, Pn), -1, np.int32)
    B = np.full((T, Pn), -1, np.int32)
    for s in range(Pn):
        for m in range(M):
            tf = s + m if m <= Pn - 1 - s else 2 * m + s
            F[tf, s] = m
            B[2 * Pn - 1 + 2 * m - s, s] = m
    R = np.full((T, Pn), -1, np.int32)
    R[1:, 1:] = F[:-1, :-1]
    # One unit per slot: an F and a B on the same (slot, stage) would
    # silently drop one (wrong gradients, not a crash).
    assert not np.any((F >= 0) & (B >= 0))
    return F, B, R


@functools.lru_cache(maxsize=64)
def _plain_schedule(M: int, P: int) -> Interleaved1F1B:
    """The closed-form 1F1B tables in the interleaved schedule's form
    (V = 1), so one executor runs both: inputs in a P-slot buffer keyed
    m mod P (stage 0 reads its microbatch directly), each cotangent in a
    one-slot buffer read in the slot it arrives."""
    F, B, R = _1f1b_tables(M, P)
    T = F.shape[0]
    action = np.where(F >= 0, 1, np.where(B >= 0, 2, 0)).astype(np.int32)
    unit_m = np.where(F >= 0, F, B).astype(np.int32)
    unit_v = np.where(action > 0, 0, -1).astype(np.int32)
    stage = np.broadcast_to(np.arange(P, dtype=np.int32), (T, P))
    f_in = np.where((F >= 0) & (stage > 0), F % P, -1).astype(np.int32)
    b_in = np.where((B >= 0) & (stage > 0), B % P, -1).astype(np.int32)
    b_cot = np.where((B >= 0) & (stage < P - 1), 0, -1).astype(np.int32)
    act_store = np.where(R >= 0, R % P, -1).astype(np.int32)
    cot_store = b_cot.copy()
    return Interleaved1F1B(
        num_slots=T, num_stages=P, virtual_stages=1, num_microbatches=M,
        xbuf_slots=P, cbuf_slots=1, action=action, unit_v=unit_v,
        unit_m=unit_m, f_in=f_in, b_in=b_in, b_cot=b_cot,
        act_store=act_store, cot_store=cot_store)


@functools.lru_cache(maxsize=64)
def _interleaved_schedule(M: int, P: int, V: int) -> Interleaved1F1B:
    sched = build_schedule(M, P, V)
    check_schedule(sched)
    return sched


class _Scheduled(torch.autograd.Function):
    """The 1F1B pass: the forward tick loop without a graph, and the
    hand-scheduled backward of :func:`_scheduled_backward`. Saves only
    its inputs (the stage's parameters and the microbatches)."""

    @staticmethod
    def forward(ctx, plan, xm, em, *leaves):
        ctx.plan, ctx.em = plan, em
        ctx.save_for_backward(xm, *leaves)
        return plan.forward(leaves, xm, em)

    @staticmethod
    def backward(ctx, ym_bar):
        xm, *leaves = ctx.saved_tensors
        dxm, dleaves = ctx.plan.backward(leaves, xm, ctx.em, ym_bar)
        return (None, dxm, None, *dleaves)


class _Plan:
    """What a 1F1B pass needs on this rank: the stage, its tree, the
    group and the slot tables."""

    def __init__(self, stage_fn, tree, group, idx: int, sched,
                 chunked: bool):
        self.stage_fn, self.tree, self.group = stage_fn, tree, group
        self.idx, self.sched, self.chunked = idx, sched, chunked
        self.P, self.V = sched.num_stages, sched.virtual_stages

    def params(self, leaves):
        return _rebuild(self.tree, iter(leaves))

    def forward(self, leaves, xm, em):
        return _forward_ticks(self.stage_fn, self.params(leaves), xm, em,
                              self.group, self.idx, self.P, self.V,
                              self.chunked)

    def _chunk(self, leaves, v):
        return [leaf[v] for leaf in leaves] if self.chunked else leaves

    def _run(self, leaves, x, em, m):
        args = (self.params(leaves), x)
        return self.stage_fn(*args) if em is None else self.stage_fn(
            *args, em[m])

    def backward(self, leaves, xm, em, ym_bar):
        """Every slot: the activation hop (forward direction), then the
        cotangent hop (reverse), each posted by both ends of its live
        edges only; then this rank's unit: a forward recompute (without
        a graph, only where its output feeds a later stage) or a
        backward (the stage's forward again under autograd, and its
        gradients for the cotangent). The input cotangents of global
        stage 0 come out whole on every rank (an all-reduce over pp)."""
        sched, P, V, d = self.sched, self.P, self.V, self.idx
        C = V * P
        xbuf = [None] * sched.xbuf_slots
        cbuf = [None] * sched.cbuf_slots
        dleaves = [torch.zeros_like(leaf) for leaf in leaves]
        dxm = torch.zeros_like(xm)
        like = xm[0]
        prev_act = prev_cot = None
        nxt, before = (d + 1) % P, (d - 1) % P
        for t in range(sched.num_slots):
            sends = sched.act_store[t, nxt] >= 0
            slot = int(sched.act_store[t, d])
            got = exchange(prev_act if sends else None, self.group,
                           nxt if sends else None,
                           before if slot >= 0 else None, like)
            if slot >= 0:
                xbuf[slot] = got
            sends = sched.cot_store[t, before] >= 0
            slot = int(sched.cot_store[t, d])
            got = exchange(prev_cot if sends else None, self.group,
                           before if sends else None,
                           nxt if slot >= 0 else None, like)
            if slot >= 0:
                cbuf[slot] = got
            prev_act = prev_cot = None
            action = int(sched.action[t, d])
            if action == 0:
                continue
            v, m = int(sched.unit_v[t, d]), int(sched.unit_m[t, d])
            s = v * P + d
            chunk = self._chunk(leaves, v)
            if action == 1:
                if s < C - 1:
                    x_in = (xbuf[sched.f_in[t, d]] if sched.f_in[t, d] >= 0
                            else xm[m])
                    with torch.no_grad():
                        prev_act = self._run(chunk, x_in, em, m)
                continue
            x_in = xbuf[sched.b_in[t, d]] if sched.b_in[t, d] >= 0 else xm[m]
            cot = (cbuf[sched.b_cot[t, d]] if sched.b_cot[t, d] >= 0
                   else ym_bar[m])
            with torch.enable_grad():
                params = [leaf.detach().requires_grad_(leaf.requires_grad)
                          for leaf in chunk]
                x = x_in.detach().requires_grad_(True)
                y = self._run(params, x, em, m)
                wanted = [p for p in params if p.requires_grad] + [x]
                grads = torch.autograd.grad(y, wanted, cot,
                                            allow_unused=True)
            grads = iter(grads)
            with torch.no_grad():
                for i, p in enumerate(params):
                    if not p.requires_grad:
                        continue
                    g = next(grads)
                    if g is not None:
                        (dleaves[i][v] if self.chunked
                         else dleaves[i]).add_(g)
                dx = next(grads)
            if s > 0:
                prev_cot = dx
            else:
                dxm[m] = dx
        if P > 1:
            all_reduce(dxm, self.group)
        return dxm, dleaves


def _scheduled_engine(stage_fn, mesh, axis: str, output: str, schedule,
                      chunked: bool):
    def pipeline(stage_params, xm, em):
        params = _own_stage(stage_params)
        group = mesh.group(axis)
        plan = _Plan(stage_fn, params, group, mesh.index(axis),
                     schedule(xm.shape[0]), chunked)
        outbuf = _Scheduled.apply(plan, xm, em, *_leaves(params))
        return _emit(outbuf, group, output)

    return pipeline


def one_f_one_b(
    stage_fn: StageFn,
    mesh,
    *,
    num_microbatches: int,
    axis: str = "pp",
    activation_spec=None,
    extra_spec=None,
    extra_manual_axes: tuple[str, ...] = (),
    output: str = "replicated",
    uniform_collectives: bool | None = None,
):
    """1F1B (PipeDream-flush) pipeline schedule. Same contract and same
    bubble fraction as :func:`gpipe`; the difference is the BACKWARD: a
    hand-scheduled interleave (``_Scheduled``) in which each slot runs
    one forward recompute or one backward of the stage, stage inputs
    wait in a P-slot buffer, and parameter gradients accumulate. Live
    microbatch state in the backward is O(P) however large M grows.
    Compute is that of ``gpipe(remat=True)``: M forwards and M
    recompute-backwards a stage.

    ``uniform_collectives``: kept from the reference's argument list; the
    port's slots are uniform within every group by construction (module
    docstring), so both values run the same schedule."""
    num_stages = mesh.shape[axis]
    act_spec = () if activation_spec is None else activation_spec
    _validate(act_spec, output, num_microbatches, num_stages)
    if uniform_collectives not in (None, True, False):
        raise ValueError("uniform_collectives must be a bool or None")
    return _microbatched(
        _scheduled_engine(stage_fn, mesh, axis, output,
                          lambda M: _plain_schedule(M, num_stages), False),
        num_microbatches)


def interleaved_one_f_one_b(
    stage_fn: StageFn,
    mesh,
    *,
    num_microbatches: int,
    virtual_stages: int,
    axis: str = "pp",
    activation_spec=None,
    extra_spec=None,
    extra_manual_axes: tuple[str, ...] = (),
    output: str = "replicated",
    uniform_collectives: bool | None = None,
):
    """Interleaved 1F1B: the virtual-stage forward of
    :func:`interleaved_gpipe` with a hand-scheduled PipeDream-flush
    backward — O(P·V) live microbatch state (the static schedule's
    buffer depth) however large M grows, at V·P pipeline depth with the
    P-1-tick fill bubble.

    The slot tables come from :mod:`kubeflow_tpu_torch.parallel.
    schedule1f1b`, simulated under the Megatron discipline and validated
    by its independent checker; activation and cotangent buffer slots
    are assigned statically. Both ring directions use the full ring:
    the wrap edges carry chunk boundaries (activations P-1 -> 0,
    cotangents 0 -> P-1). ``uniform_collectives`` as in
    :func:`one_f_one_b`."""
    num_stages = mesh.shape[axis]
    _check_virtual(virtual_stages, num_microbatches, num_stages)
    act_spec = () if activation_spec is None else activation_spec
    _validate(act_spec, output, num_microbatches, num_stages)
    if uniform_collectives not in (None, True, False):
        raise ValueError("uniform_collectives must be a bool or None")
    return _microbatched(
        _scheduled_engine(
            stage_fn, mesh, axis, output,
            lambda M: _interleaved_schedule(M, num_stages, virtual_stages),
            True),
        num_microbatches)


# ------------------------------------------------------------ layouts


def stage_stack_interleaved(params, num_stages: int, virtual_stages: int):
    """Reshape a depth-stacked layer tree ``(L, ...)`` into the
    interleaved stage layout ``(P, V, L/(V*P), ...)``: global stage
    c = v*P + d holds layers [c*L/C, (c+1)*L/C) and lives at [d, v] —
    device-major round robin, so consecutive chunks sit on consecutive
    ranks and each rank's chunks are P apart."""
    C = num_stages * virtual_stages

    def reshape(leaf):
        depth = leaf.shape[0]
        if depth % C:
            raise ValueError(
                f"layer stack depth {depth} not divisible by "
                f"pp*virtual={C} chunks"
            )
        return leaf.reshape(
            virtual_stages, num_stages, depth // C, *leaf.shape[1:]
        ).transpose(0, 1)

    return _map(reshape, params)


def stage_stack(params, num_stages: int):
    """Reshape a depth-stacked layer tree ``(L, ...)`` into the stage
    layout ``(P, L/P, ...)`` gpipe shards: contiguous groups of L/P
    consecutive layers per stage (row-major reshape = stage order)."""

    def reshape(leaf):
        depth = leaf.shape[0]
        if depth % num_stages:
            raise ValueError(
                f"layer stack depth {depth} not divisible by "
                f"pp={num_stages} stages"
            )
        return leaf.reshape(num_stages, depth // num_stages,
                            *leaf.shape[1:])

    return _map(reshape, params)


__all__ = ["pipeline_ticks", "gpipe", "one_f_one_b", "interleaved_gpipe",
           "interleaved_one_f_one_b", "stage_stack",
           "stage_stack_interleaved", "StageFn"]

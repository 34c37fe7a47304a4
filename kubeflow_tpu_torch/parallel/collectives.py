"""The collectives the sharded models run, written out by hand.

The reference lets XLA insert its collectives (GSPMD over a sharded
``jit``, ``ppermute`` inside ``shard_map``). The port calls
``torch.distributed`` on plain local tensors instead, so every kernel
wrapper and every custom ``autograd.Function`` sees the contiguous
device tensors it takes. The differentiable ones come in conjugate
pairs (Megatron's f and g, gather and scatter, a rotation and its
inverse): the backward of each is the forward of its partner.

Every collective runs on the group it is given, a group of one included:
on the card at world 1 the NCCL calls are real calls. The exceptions
are the point-to-point hops (:func:`shift`, :func:`exchange`,
:class:`Hop`): a ring of one has no neighbour to talk to, so its hop is
the tensor itself and posts nothing.

The pipeline's hops (:func:`exchange`, :class:`Hop`) take their edges
from a static schedule that both ends of every edge read alike: a hop
that carries nothing on a tick (a bubble's) posts no message on either
end, and every other is one batched isend/irecv pair.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    dist.all_reduce(t, group=group)
    return t


def all_reduce_flat(tensors: list, group) -> list:
    """Sum every tensor of ``tensors`` (one dtype) over ``group`` in one
    call: copied into one flat buffer, reduced, returned as views of it
    in their own shapes."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in group
    rank order (contiguous)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size())]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` and keep this rank's block along
    ``dim`` (contiguous)."""
    parts = [p.contiguous() for p in x.chunk(group.size(), dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def own_block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (its group rank's)."""
    size = x.shape[dim] // group.size()
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


def shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """Send ``x`` to group rank ``(i + step) % n`` and receive from
    ``(i - step) % n`` (one batched isend/irecv pair, waited for)."""
    n, i = group.size(), dist.get_rank(group)
    return exchange(x, group, (i + step) % n, (i - step) % n)


def exchange(x, group, dst=None, src=None, like=None):
    """One point-to-point hop on ``group``: send ``x`` to group rank ``dst``
    and receive from group rank ``src`` a tensor shaped and typed like
    ``like`` (``x`` when None), in one batched isend/irecv, waited for.
    Either end may be None (nothing sent, nothing received). Returns what
    was received, or None. In a group of one the hop is ``x`` itself."""
    if group.size() == 1:
        return x if src is not None else None
    like = x if like is None else like
    ops, out = [], None
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, dst), group))
    if src is not None:
        out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class Hop(torch.autograd.Function):
    """:func:`exchange` under autograd: ``x`` (or None) to ``dst``, and
    the result from ``src`` (an empty tensor when nothing is received).
    Its backward is the reverse hop: the result's gradient goes back to
    ``src`` and ``x``'s comes from ``dst``.

    ``anchor`` (a tensor that requires grad, or None) makes the node
    exist where ``x`` is None or carries no gradient: a hop that only
    receives must still send the gradient back. Autograd runs a node only
    where the loss reaches it, so the pipeline ties every hop's result
    into its output (``parallel.pipeline``): every rank then runs every
    reverse hop, in the reverse of the forward's order."""

    @staticmethod
    def forward(ctx, x, anchor, like, group, dst, src):
        ctx.group, ctx.dst, ctx.src = group, dst, src
        ctx.like = (like.shape, like.dtype, like.device)
        out = exchange(x, group, dst, src, like)
        if out is None:
            return like.new_empty((0,))
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        like = torch.empty(shape, dtype=dtype, device=device)
        if ctx.src is not None and g is None:
            g = torch.zeros_like(like)
        gx = exchange(g if ctx.src is not None else None, ctx.group,
                      dst=ctx.src, src=ctx.dst, like=like)
        return gx, None, None, None, None, None


class Tie(torch.autograd.Function):
    """Identity on ``y`` whose backward also hands each of ``tied`` a zero
    gradient (an expanded zero: no memory), so that every node that made
    them runs in the backward wherever ``y`` is reached."""

    @staticmethod
    def forward(ctx, y, *tied):
        ctx.tied = [(t.shape, t.dtype, t.device) for t in tied]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros((), dtype=dtype, device=device).expand(shape)
                     for shape, dtype, device in ctx.tied))


class Rotate(torch.autograd.Function):
    """One clockwise hop of a ring: rank i's ``x`` goes to rank i+1. Its
    backward is the counter-clockwise hop of the gradient (what JAX's
    ``ppermute`` transposes to)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.group, -1), None


class CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient
    backward. Enters a column-parallel product whose input is replicated
    over the group and whose gradient each rank holds in part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: all-reduce forward (the row-parallel product's
    partial sums), identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherFromGroup(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward keeps this rank's block
    of the gradient, which every rank holds whole and equal (the product
    after it runs replicated and leaves through :class:`ScatterToGroup`)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return own_block(g, ctx.dim, ctx.group), None, None


class ReduceScatterToGroup(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward (the sum over the group, this
    rank's block of it); all-gather of the gradient backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class ScatterToGroup(torch.autograd.Function):
    """This rank's block along ``dim`` forward; all-gather of the
    gradient backward (the partner of :class:`GatherFromGroup`)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return own_block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None

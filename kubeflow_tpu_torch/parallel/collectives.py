"""The collectives the sharded models run, written out by hand.

The reference lets XLA insert its collectives (GSPMD over a sharded
``jit``, ``ppermute`` inside ``shard_map``). The port calls
``torch.distributed`` on plain local tensors instead, so every kernel
wrapper and every custom ``autograd.Function`` sees the contiguous
device tensors it takes. The differentiable ones come in conjugate
pairs (Megatron's f and g, gather and scatter, a rotation and its
inverse): the backward of each is the forward of its partner.

Every collective runs on the group it is given, a group of one included:
on the card at world 1 the NCCL calls are real calls. The one exception
is :func:`shift`, whose ring of one has no neighbour to talk to.
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
    n = group.size()
    if n == 1:
        return x
    i = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (i + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (i - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


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

"""fsdp's all-gathers, one block at a time.

The reference lets GSPMD all-gather an fsdp-sharded weight where a
product needs it and reduce-scatter its gradient; the port writes both
out, so that a whole weight lives only while something uses it:

- :class:`GatherShard` all-gathers a shard along its fsdp dim in the
  forward and reduce-scatters the whole gradient back to the shard in
  the backward, so autograd differentiates the shard itself.
- :func:`gathered_call` runs one block's forward on its weights with
  every fsdp leaf gathered, under ``saved_tensors_hooks``: wherever
  autograd would keep a gathered weight for the backward (the weight, its
  cast to the compute dtype, or a view of either, as the products save
  them; a conv kernel's dims reordered and cast to channels-last), it
  keeps a :class:`_Regather` handle instead, and the block's
  backward all-gathers the shard again where it unpacks the handle. The
  forward's whole weights are freed when the block returns.

**Collective order.** The gathers and reduce-scatters now run inside the
backward, where autograd's engine runs, of the nodes the loss reaches,
always the one created last: the reverse of the forward's program order
on every rank. Ranks whose ring skips different hops (their packed rows
differ) build fewer product nodes but the same collective nodes
(the ring's ``collectives.Tie``), so every group sees its collectives in one
order.
"""

from __future__ import annotations

import re

import torch

from kubeflow_tpu_torch.parallel.collectives import (
    all_gather_dim,
    reduce_scatter_dim,
)


class GatherShard(torch.autograd.Function):
    """All-gather of ``shard`` along ``dim`` over ``group`` (the whole
    weight); backward: reduce-scatter of its gradient back to the shard."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.shard, ctx.dim, ctx.group = shard, dim, group
        return all_gather_dim(shard.detach(), dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def gather_leaves(mesh, tree: dict, placements: dict,
                  prefix: str = "") -> dict:
    """``tree`` with each fsdp-sharded leaf (``placements`` keyed by
    ``flatten`` path under ``prefix``) gathered through
    :class:`GatherShard`; every other leaf as it is."""
    group = mesh.group("fsdp")

    def fetch(key, leaf):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(leaf, dict):
            return {k: fetch(f"{key}/{k}", v) for k, v in leaf.items()}
        placement = placements[path]
        if "fsdp" not in placement:
            return leaf
        return GatherShard.apply(leaf, placement.index("fsdp"), group)

    return {key: fetch(key, leaf) for key, leaf in tree.items()}


# Autograd nodes that make a view of their one input (names without the
# overload digits), and the cast node.
_VIEWS = frozenset({"View", "UnsafeView", "ReshapeAlias", "Permute",
                    "Transpose", "T", "Unsqueeze", "Squeeze", "Expand",
                    "Alias", "AsStrided", "Slice", "Select"})
_CAST = "ToCopy"


def _node_kind(node) -> str:
    return re.sub(r"Backward\d*$", "", type(node).__name__)


class _Regather:
    """What a block keeps of a gathered weight for its backward: the
    shard to gather again, the permutes ahead of the first cast (a conv
    kernel's HWIO -> OIHW), the casts and the layout they wrote (a cast may change the memory format,
    as a conv kernel cast to channels-last does), and the saved tensor's
    view of the result."""

    def __init__(self, ctx, chain: list, dtype, t: torch.Tensor):
        self.shard, self.dim, self.group = ctx.shard, ctx.dim, ctx.group
        kinds = [kind for kind, _ in chain]
        self.casts = kinds.count(_CAST)
        first = kinds.index(_CAST) if self.casts else 0
        if any(kind != "Permute" for kind in kinds[:first]):
            raise RuntimeError(
                f"a block saves a {tuple(t.shape)} {t.dtype} tensor cast "
                f"after the views {kinds[:first]} of a gathered fsdp weight: "
                "the per-block gather replays only a permute there")
        self.permutes = [node._saved_dims for _, node in chain[:first]]
        self.dtype, self.out_dtype = dtype, t.dtype
        base = t if t._base is None else t._base
        self.layout = (base.size(), base.stride())
        self.geometry = (t.size(), t.stride(), t.storage_offset())

    def unpack(self) -> torch.Tensor:
        whole = all_gather_dim(self.shard.detach(), self.dim, self.group)
        for dims in self.permutes:
            whole = whole.permute(dims)
        if self.casts == 2:
            whole = whole.to(self.dtype)
        if self.casts:
            whole = torch.empty_strided(
                *self.layout, dtype=self.out_dtype,
                device=whole.device).copy_(whole)
        return whole.as_strided(*self.geometry)


def _pack_for(dtype):
    def pack(t):
        node, chain = t.grad_fn, []
        while node is not None and not isinstance(
                node, GatherShard._backward_cls):
            kind = _node_kind(node)
            if kind != _CAST and kind not in _VIEWS:
                return t
            chain.append((kind, node))
            inputs = [n for n, _ in node.next_functions if n is not None]
            node = inputs[0] if len(inputs) == 1 else None
        if node is None:
            return t
        casts = sum(kind == _CAST for kind, _ in chain)
        whole = node.shard.numel() * node.group.size()
        if casts > 2 or t.untyped_storage().nbytes() != (
                whole * t.element_size()):
            raise RuntimeError(
                f"a block saves a {tuple(t.shape)} {t.dtype} tensor made "
                f"from a gathered fsdp weight through {casts} casts and a "
                "copy: the per-block gather cannot rebuild it")
        return _Regather(node, chain[::-1], dtype, t)

    return pack


def _unpack(saved):
    return saved.unpack() if isinstance(saved, _Regather) else saved


def gathered_call(mesh, fn, shards: dict, placements: dict, prefix: str,
                  dtype):
    """``fn(weights)`` where ``weights`` is ``shards`` (one block's
    parameter dict, its leaves keyed ``prefix/...`` in ``placements``)
    with every fsdp leaf gathered whole. Under autograd, what the forward
    saves of a gathered weight is gathered again in the backward
    (``dtype`` is the compute dtype the weights are cast through), so no
    whole weight outlives this call."""
    if mesh is None or mesh.shape["fsdp"] == 1:
        return fn(shards)
    weights = gather_leaves(mesh, shards, placements, prefix)
    if not torch.is_grad_enabled():
        return fn(weights)
    with torch.autograd.graph.saved_tensors_hooks(_pack_for(dtype),
                                                  _unpack):
        return fn(weights)


__all__ = ["GatherShard", "gather_leaves", "gathered_call"]

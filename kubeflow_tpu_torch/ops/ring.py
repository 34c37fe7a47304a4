"""Ring attention: sequence (context) parallelism over the ``sp`` group.

The counterpart of ``kubeflow_tpu/ops/ring.py``. The sequence is sharded
over the mesh's ``sp`` axis; each rank holds a q/k/v shard, folds the
block of the k/v shard it currently holds into running online-softmax
statistics (f32 ``m``, ``l`` and ``o``), and passes k/v to its ring
neighbour. After ``sp`` hops every query has attended to every key while
each rank only ever stores one shard.

The reference computes each hop with ``jnp.einsum`` on the input dtype
and f32 accumulation, outside any Pallas kernel; :func:`ring_hop` keeps
those products as torch products (operands widened to f32, which is
exact for bf16 values, as ``tied_head`` does), so there is no kernel
here. Running a hop through the flash kernel with lse waits for q/k
offsets in that kernel (the window band between shards needs them).

Composes with GQA (q folds to (kv_heads, group), so the shards on the
ring stay compact), sliding windows (the banded mask) and packed
segment ids. Dead hops are skipped: a (q shard, k shard) pair above the
causal diagonal, outside the window band, or in disjoint documents
contributes nothing, so its products do not run and only the rotation
does. Causal and window hops are decided from Python ints. The segment
test needs every shard's per-row [min, max] document range; the port
all-gathers them once per call and reads them to the host in one
synchronous device-to-host copy before the first hop (the reference
rotates the ranges with k/v and tests them on the device each hop).

Differentiable: k and v travel as one stacked tensor through
:class:`~kubeflow_tpu_torch.parallel.collectives.Rotate`, whose backward
is the reverse hop, so their gradients flow home along the ring as
JAX's ``scan`` + ``ppermute`` transpose does; one tensor keeps the
forward and the backward to one message per hop, in one order on every
rank. Autograd runs only the nodes the loss reaches, and a rank whose
last hops are dead would skip their reverse hops while its neighbours
wait on it; :class:`~kubeflow_tpu_torch.parallel.collectives.Tie` ties
the last rotation's output into the result, so every rank runs every
reverse hop.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.ops.attention import NEG_INF, _causal_mask
from kubeflow_tpu_torch.parallel.collectives import (
    Rotate,
    Tie,
    all_gather_dim,
    shift,
)


def ring_hop(qg, k_t, v_t, carry, *, q_index: int, src: int, s_local: int,
             scale: float, causal: bool = False, window: int | None = None,
             seg_q=None, seg_k=None):
    """Fold the block of k/v shard ``src`` into ``carry = (o, m, l)``.

    qg: this rank's queries folded to (B, Hkv, group, S_local, d); k_t,
    v_t: shard ``src``'s (B, Hkv, S_local, d); o (B, Hkv, group, S_local,
    d), m and l (..., 1), all f32. Scores are q·k in f32 times
    ``scale``, masked causally at the shards' global offsets
    (``q_index`` and ``src`` times ``s_local``) and by segment ids
    (``seg_q``, ``seg_k``: (B, S_local)); p is rounded to v's dtype
    before the PV product, as the reference casts it."""
    o, m, l = carry
    s = torch.einsum("bngqd,bnkd->bngqk", qg.float(), k_t.float()) * scale
    if causal:
        s = _causal_mask(s, q_index * s_local, src * s_local, window)
    if seg_q is not None:
        keep = seg_q[:, None, None, :, None] == seg_k[:, None, None, None, :]
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = alpha * l + p.sum(dim=-1, keepdim=True)
    o_new = o * alpha + torch.einsum("bngqk,bnkd->bngqd",
                                     p.to(v_t.dtype).float(), v_t.float())
    return o_new, m_new, l_new


def hop_live(q_index: int, src: int, s_local: int, causal: bool,
             window: int | None, q_range=None, k_range=None) -> bool:
    """Whether k shard ``src`` can reach q shard ``q_index``: the
    shard-level form of the flash kernels' tile-skip predicates (block =
    ``s_local``). ``q_range``/``k_range`` are per-row (mins, maxs)
    lists of document ids, for packed batches."""
    if causal:
        if src > q_index:
            return False
        if window is not None and (
                (src + 1) * s_local + window <= q_index * s_local + 1):
            return False
    if q_range is not None:
        return any(q_lo <= k_hi and k_lo <= q_hi for q_lo, q_hi, k_lo, k_hi
                   in zip(*q_range, *k_range))
    return True


def _check(q, k, causal, window):
    if window is not None:
        if not causal:
            raise ValueError("window requires causal attention")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"q heads {q.shape[1]} not a multiple of kv heads {k.shape[1]}")


def ring_attention(q, k, v, *, group, causal: bool = False, scale=None,
                   window: int | None = None, segment_ids=None):
    """Attention over a sequence sharded across ``group`` (the mesh's sp
    process group; every member calls it).

    q: this rank's shard (batch, heads, seq_local, head_dim); k/v the
    same with ``kv_heads`` dividing ``heads`` (GQA), the shards laid in
    group-rank order along the global sequence. ``window`` bands the
    causal mask as ``flash_attention``'s does. ``segment_ids`` is the
    LOCAL (batch, seq_local) shard of a packed batch's document ids,
    non-decreasing along the GLOBAL sequence. Returns the local output
    shard in q's dtype."""
    _check(q, k, causal, window)
    n, me = group.size(), dist.get_rank(group)
    b, h, s_local, d = q.shape
    h_kv = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, h_kv, h // h_kv, s_local, d)
    ranges = [None] * n
    if segment_ids is not None:
        bounds = torch.stack([segment_ids.amin(dim=1),
                              segment_ids.amax(dim=1)])
        gathered = all_gather_dim(bounds, 0, group).tolist()   # host sync
        ranges = [gathered[2 * r:2 * r + 2] for r in range(n)]
    o = q.new_zeros((b, h_kv, h // h_kv, s_local, d), dtype=torch.float32)
    m = torch.full(o.shape[:-1] + (1,), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    kv, seg_t = torch.stack([k, v]), segment_ids
    for t in range(n):
        # After t clockwise hops this rank holds shard (me - t) mod n.
        src = (me - t) % n
        if hop_live(me, src, s_local, causal, window, ranges[me],
                    ranges[src]):
            o, m, l = ring_hop(qg, kv[0], kv[1], (o, m, l), q_index=me,
                               src=src, s_local=s_local, scale=scale,
                               causal=causal, window=window,
                               seg_q=segment_ids, seg_k=seg_t)
        if t < n - 1:
            kv = Rotate.apply(kv, group)
            if segment_ids is not None:
                seg_t = shift(seg_t, group)
    if n > 1 and kv.requires_grad and torch.is_grad_enabled():
        o = Tie.apply(o, kv)
    # Every row sees at least its own key (causal and packed rows
    # include the diagonal), so l > 0.
    return (o / l).reshape(b, h, s_local, d).to(q.dtype)


def make_ring_attention(mesh, axis_name: str = "sp",
                        window: int | None = None):
    """Whole-sequence wrapper: ``attend(q, k, v, causal=False,
    segment_ids=None)`` takes (batch, heads, seq, head_dim) tensors (and
    (batch, seq) ids) over the WHOLE sequence, runs the ring on this
    rank's shard of it along ``axis_name``, and returns that shard of the
    output, (batch, heads, seq / n, head_dim)."""

    def attend(q, k, v, causal=False, segment_ids=None):
        _check(q, k, causal, window)
        n, i = mesh.size(axis_name), mesh.index(axis_name)
        s_local = q.shape[2] // n
        if q.shape[2] % n:
            raise ValueError(f"sequence {q.shape[2]} does not divide over "
                             f"{axis_name}={n}")

        def block(t, dim):
            return t.narrow(dim, i * s_local, s_local)

        seg = None if segment_ids is None else block(segment_ids, 1)
        return ring_attention(block(q, 2), block(k, 2), block(v, 2),
                              group=mesh.group(axis_name), causal=causal,
                              window=window, segment_ids=seg)

    return attend


__all__ = ["ring_attention", "make_ring_attention", "ring_hop", "hop_live"]

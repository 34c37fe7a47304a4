"""Vocab-tiled softmax cross-entropy against the tied embedding.

The counterpart of ``kubeflow_tpu/ops/cross_entropy.py``. The LM's dense
loss builds the (N, vocab) f32 logits, keeps their softmax for the
backward and builds their gradient: at S = 8192 and vocab 32768 that is
1 GiB each. :func:`fused_ce` computes each position's NLL straight from
the pre-head hidden states instead: it walks the vocab in tiles of
``block`` rows of the embedding with an online logsumexp (the flash
trick over the vocab axis), and keeps only ``(x, emb, targets, lse)``
for the backward, which recomputes each tile's logits, forms
``p - onehot`` from the saved logsumexp and runs both backward products
on compute-dtype operands with f32 accumulation. No (N, vocab) tensor
exists at any time; the largest is one (N, block) f32 tile.

The tile products are plain GEMMs with f32 outputs from compute-dtype
operands (the reference's ``preferred_element_type=float32``). On the
card they take ``torch.mm(a, b, out_dtype=torch.float32)`` (cuBLAS,
bf16 operands, f32 accumulation and output); elsewhere the operands are
widened to f32 first, which is exact for bf16 values, as ``tied_head``
does. No hand-written kernel: the reference computes this module
outside any Pallas kernel too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Finite "minus infinity" of the padded columns: exp(NEG_INF - m) is 0.
NEG_INF = -1e30


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 accumulation and an f32 result, the operands
    in their own (compute) dtype."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _tiles(emb: torch.Tensor, block: int, compute_dtype) -> torch.Tensor:
    """The (V, D) table in the compute dtype, padded with zero rows up to
    a multiple of ``block``; the padded columns are masked in every
    tile that holds them."""
    pad = (-emb.shape[0]) % block
    return F.pad(emb.to(compute_dtype), (0, 0, 0, pad))


def _tile_logits(xc, table, t0, block, vocab) -> torch.Tensor:
    """(N, block) f32 logits of vocab rows [t0, t0 + block), the padded
    columns at NEG_INF."""
    logits = _mm_f32(xc, table[t0:t0 + block].t())
    if t0 + block > vocab:
        logits[:, vocab - t0:] = NEG_INF
    return logits


def _forward(x, emb, targets, block, compute_dtype):
    """(nll (N,) f32, lse (N,) f32) by one pass over the vocab tiles."""
    vocab = emb.shape[0]
    n = x.shape[0]
    xc = x.to(compute_dtype)
    table = _tiles(emb, block, compute_dtype)
    m = torch.full((n,), NEG_INF, dtype=torch.float32, device=x.device)
    s = torch.zeros(n, dtype=torch.float32, device=x.device)
    tgt = torch.full((n,), NEG_INF, dtype=torch.float32, device=x.device)
    for t0 in range(0, table.shape[0], block):
        logits = _tile_logits(xc, table, t0, block, vocab)
        m_new = torch.maximum(m, logits.amax(dim=1))
        local = (targets - t0).clamp(0, block - 1)
        t_log = logits.gather(1, local[:, None])[:, 0]
        in_tile = (targets >= t0) & (targets < t0 + block)
        tgt = torch.where(in_tile, t_log, tgt)
        s = s * torch.exp(m - m_new) + logits.sub_(m_new[:, None]).exp_().sum(
            dim=1)
        m = m_new
    lse = m + torch.log(s)
    return lse - tgt, lse


def _backward(x, emb, targets, lse, g, block, compute_dtype):
    """(dx in x.dtype, demb in emb.dtype): per tile, dlogits = (p -
    onehot) * g rounded to the compute dtype, then dx += dlog @ tile and
    the tile's rows of demb = dlog^T @ x, both f32-accumulated."""
    vocab, d = emb.shape
    n = x.shape[0]
    xc = x.to(compute_dtype)
    table = _tiles(emb, block, compute_dtype)
    dx = torch.zeros(n, d, dtype=torch.float32, device=x.device)
    demb = torch.empty(table.shape[0], d, dtype=torch.float32,
                       device=x.device)
    for t0 in range(0, table.shape[0], block):
        p = _tile_logits(xc, table, t0, block, vocab)
        p.sub_(lse[:, None]).exp_()   # padded columns: exp(-inf) = 0
        # p - onehot: -1 at the target's column where the tile holds it,
        # -0 (no change) at a clamped column elsewhere; no host sync.
        in_tile = (targets >= t0) & (targets < t0 + block)
        local = (targets - t0).clamp(0, block - 1)
        p.scatter_add_(1, local[:, None], -in_tile.float()[:, None])
        dlog = p.mul_(g[:, None]).to(compute_dtype)
        tile = table[t0:t0 + block]
        dx += _mm_f32(dlog, tile)
        demb[t0:t0 + block] = _mm_f32(dlog.t(), xc)
    return dx.to(x.dtype), demb[:vocab].to(emb.dtype)


class _FusedCE(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward keeps ``(x, emb,
    targets, lse)`` only (it runs under ``no_grad``, so no tile is held
    for autograd); the backward recomputes the tiles."""

    @staticmethod
    def forward(ctx, x, emb, targets, block, compute_dtype):
        nll, lse = _forward(x, emb, targets, block, compute_dtype)
        ctx.save_for_backward(x, emb, targets, lse)
        ctx.block, ctx.compute_dtype = block, compute_dtype
        return nll

    @staticmethod
    def backward(ctx, g):
        x, emb, targets, lse = ctx.saved_tensors
        dx, demb = _backward(x, emb, targets, lse, g.float(), ctx.block,
                             ctx.compute_dtype)
        return dx, demb, None, None, None


def fused_ce(x, emb, targets, block: int = 4096, compute_dtype=None):
    """Per-position NLL of ``targets`` under logits ``x @ emb.T``.

    x: (N, D) hidden states; emb: (V, D) tied embedding table; targets:
    (N,) integer ids. The products run in ``compute_dtype`` (None: x's
    own dtype, the model's activation dtype) with f32 accumulation.
    Returns (N,) f32 NLL; masking and averaging stay with the caller.
    Differentiable in x and emb."""
    if block < 1:
        raise ValueError(f"block={block} must be >= 1")
    compute_dtype = x.dtype if compute_dtype is None else compute_dtype
    return _FusedCE.apply(x, emb, targets.long(), int(block), compute_dtype)


def next_token_targets(tokens, segment_ids=None):
    """(targets, valid) of the next-token loss at EVERY position of a
    (B, S) batch: ``targets[:, p] = tokens[:, p + 1]``, ``valid`` 1.0
    where position p has a target in its own document and 0.0 at the
    last position (whose target would lie past the batch) and where the
    next token starts another document. A sequence shard of these
    predicts across its own last position into the next shard, which a
    shard of ``tokens`` alone cannot."""
    targets = F.pad(tokens[:, 1:], (0, 1))
    valid = torch.ones(tokens.shape, dtype=torch.float32,
                       device=tokens.device)
    valid[:, -1] = 0.0
    if segment_ids is not None:
        valid[:, :-1] *= (segment_ids[:, 1:] == segment_ids[:, :-1]).float()
    return targets, valid


def masked_mean(nll, valid, count=None):
    """``sum(nll * valid) / count``: ``count`` is the number of valid
    positions over the WHOLE batch (a shard's loss is its part of the
    global mean, which a mean of shard means is not when the counts
    differ); without it, this batch's own count, at least 1."""
    if count is None:
        count = valid.sum().clamp_min(1.0)
    return (nll * valid).sum() / count


def fused_lm_loss(hidden, embedding, tokens=None, segment_ids=None,
                  block: int = 4096, compute_dtype=None, *, targets=None,
                  valid=None, count=None):
    """Next-token cross entropy from the pre-head hidden states (B, S,
    D) without building the (B, S, vocab) logits: every position
    predicts its target (:func:`next_token_targets` of ``tokens`` and
    ``segment_ids``: the next token of its own document) and the loss is
    :func:`masked_mean` over ``count``, by default the batch's own.

    A sequence shard passes ``targets`` and ``valid`` instead ((B, S),
    from :func:`next_token_targets` of the whole batch and sliced like
    ``hidden``) and the whole batch's ``count``; ``tokens`` and
    ``segment_ids`` are then not read."""
    b, s, d = hidden.shape
    if targets is None:
        targets, valid = next_token_targets(tokens, segment_ids)
    nll = fused_ce(hidden.reshape(b * s, d), embedding,
                   targets.reshape(b * s), block, compute_dtype)
    return masked_mean(nll, valid.reshape(b * s), count)


__all__ = ["fused_ce", "fused_lm_loss", "next_token_targets",
           "masked_mean", "NEG_INF"]

"""The LM in plain PyTorch, float32: pre-norm blocks of causal
attention with half-split rotary embeddings (base 10000) at each row's
positions, and a tanh-GELU MLP, RMSNorm (eps 1e-6), a head tied to the
embedding. Packed rows mask attention to each document (segment ids)
and leave a document's last position without a target.

Training follows optax's ``adamw`` with a bf16 first moment: the moment
decays in bf16 (its decay rounded to bf16) and is stored in bf16, the
update reads it before that rounding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import Products


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, base: float):
    """(B, H, S, hd): position p rotates the pair (i, i + hd / 2) by p x
    base ** (-2i / hd)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = base ** (-torch.arange(half, device=x.device,
                                   dtype=torch.float32) / half)
    angles = torch.arange(x.shape[-2], device=x.device,
                          dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _mask(seq: int, segment_ids, device):
    """(B or 1, 1, S, S) keep-mask: causal, within a document."""
    pos = torch.arange(seq, device=device)
    keep = (pos[:, None] >= pos[None, :])[None, None]
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        keep = keep & same
    return keep


def hidden(w: dict, cfg: dict, tokens, segment_ids=None,
           prod: Products | None = None):
    """(B, S) tokens -> (B, S, dim) f32 states after the final norm."""
    prod = prod or Products()
    b, s = tokens.shape
    heads, kv, hd = cfg["heads"], cfg["kv_heads"], cfg["head_dim"]
    eps, base = cfg["norm_eps"], cfg["rope_base"]
    keep = _mask(s, segment_ids, tokens.device)
    x = w["embed/embedding"].float()[tokens]
    for i in range(cfg["layers"]):
        def p(name):
            return w[f"block_{i}/{name}"].float()

        h = rms_norm(x, p("RMSNorm_0/scale"), eps)
        q = prod.mm(h, p("q_proj/kernel")).view(b, s, heads, hd)
        k = prod.mm(h, p("k_proj/kernel")).view(b, s, kv, hd)
        v = prod.mm(h, p("v_proj/kernel")).view(b, s, kv, hd)
        q = rope(q.transpose(1, 2), base)
        k = rope(k.transpose(1, 2), base).repeat_interleave(heads // kv, 1)
        v = v.transpose(1, 2).repeat_interleave(heads // kv, 1)
        scores = prod.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        att = torch.softmax(scores.masked_fill(~keep, float("-inf")), -1)
        out = prod.einsum("bhqk,bhkd->bhqd", att, v)
        x = x + prod.mm(out.transpose(1, 2).reshape(b, s, heads * hd),
                        p("proj/kernel"))
        h = rms_norm(x, p("RMSNorm_1/scale"), eps)
        up = F.gelu(prod.mm(h, p("up/kernel")), approximate="tanh")
        x = x + prod.mm(up, p("down/kernel"))
    return rms_norm(x, w["final_norm/scale"].float(), eps)


def nll_sum(w: dict, cfg: dict, tokens, segment_ids,
            prod: Products | None = None):
    """(sum of the next-token losses, number of positions with a
    target): a position's target is the next token of its own
    document; each row's last position has none."""
    prod = prod or Products()
    x = hidden(w, cfg, tokens, segment_ids, prod)
    logits = prod.mm(x[:, :-1], w["embed/embedding"].float().t())
    valid = torch.ones_like(tokens[:, 1:], dtype=torch.float32)
    if segment_ids is not None:
        valid = valid * (segment_ids[:, 1:] == segment_ids[:, :-1]).float()
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          tokens[:, 1:].reshape(-1), reduction="none")
    return (nll * valid.reshape(-1)).sum(), valid.sum()


class AdamW:
    """optax ``adamw(lr, b1, b2, eps, weight_decay, mu_dtype=bf16)``
    over a flat dict of f32 leaves."""

    def __init__(self, opt: dict, params: dict):
        self.opt = opt
        self.count = 0
        self.mu = {k: torch.zeros_like(v, dtype=torch.bfloat16)
                   for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        o = self.opt
        self.count += 1
        b1 = torch.tensor(o["b1"], dtype=torch.bfloat16)
        bc1 = 1 - o["b1"] ** self.count
        bc2 = 1 - o["b2"] ** self.count
        for k, p in params.items():
            g = grads[k].float()
            mu = (1 - o["b1"]) * g + (b1.to(g.device) * self.mu[k]).float()
            self.nu[k] = (1 - o["b2"]) * g * g + o["b2"] * self.nu[k]
            u = (mu / bc1) / (torch.sqrt(self.nu[k] / bc2) + o["eps"])
            p.sub_(o["lr"] * (u + o["weight_decay"] * p))
            self.mu[k] = mu.to(torch.bfloat16)


def train(w: dict, cfg: dict, batches, opt: dict,
          prod: Products | None = None, rows: int = 2):
    """Steps of the packed next-token loss (the mean over every position
    with a target in the batch) from the f32 leaves ``w`` (updated in
    place), each batch ``(tokens, segment_ids)`` taken ``rows`` rows at
    a time, gradients summed over the blocks. Returns (losses, the
    first step's gradients)."""
    prod = prod or Products()
    for leaf in w.values():
        leaf.requires_grad_(True)
    adam = AdamW(opt, w)
    losses, first = [], None
    for tokens, seg in batches:
        count = (seg[:, 1:] == seg[:, :-1]).float().sum()
        grads = {k: torch.zeros_like(v) for k, v in w.items()}
        total = 0.0
        for r in range(0, tokens.shape[0], rows):
            part, _ = nll_sum(w, cfg, tokens[r:r + rows], seg[r:r + rows],
                              prod)
            part = part / count
            got = torch.autograd.grad(part, list(w.values()),
                                      allow_unused=True)
            for k, g in zip(w, got):
                if g is not None:
                    grads[k] += g
            total += float(part.detach())
        losses.append(total)
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        adam.step(w, grads)
    for leaf in w.values():
        leaf.requires_grad_(False)
    return losses, first

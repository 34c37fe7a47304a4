"""Self-speculative n-gram decoding: verify k drafted tokens per pass.

The counterpart of ``kubeflow_tpu/models/speculative.py``. A cheap
proposer drafts k tokens from the sequence's own history (the
continuation of the most recent earlier occurrence of the trailing
n-gram), ONE forward of k + 1 tokens (the mid-sequence chunk path of
``forward_with_cache``) scores them all, and the longest prefix of drafts
that matches the model's own choices is kept, plus the model's
correction. Every verify emits at least one token, so the output equals
plain ``generate``'s, greedy and seeded sampling; the drafts only change
how many tokens a pass retires.

Where the port differs from the reference, and why:

- **The loop runs on the host.** The reference runs draft, verify and
  accept on the device in one ``lax.while_loop``. Here each verify is
  one ``forward_with_cache`` of ``draft + 1`` tokens after rewinding
  ``cache.length`` to the accepted prefix; the n-gram search, the chunk
  and the token buffer stay on the device, and the host reads back one
  scalar per verify, the accepted count.
- **Sampling noise.** The port samples with Gumbel noise drawn in order
  from the request's ``torch.Generator`` (``generate`` draws one
  ``(1, vocab)`` row a token, the first token first), not from split
  keys. A verify scores ``draft + 1`` positions but emits only some of
  them, so the rows wait in a queue: each is drawn alone (on CUDA one
  big draw would not give the same numbers as several small ones), no
  more than the request's ``max_new_tokens - 1`` decode rows are drawn,
  and a verify pops exactly the rows of the tokens it emitted. The k-th
  emitted decode token therefore used the k-th row, and a seeded run
  equals ``generate(rng=seed)`` (not JAX's stream, which samples from
  keys).
- Identity caveat, as in the reference: the verify chunk takes the dense
  products (9 and more rows) while ``generate``'s steps take the
  single-token kernels on the card, and the two round near-tie logits
  differently there. On the CPU both are the same arithmetic and the
  tests pin token equality.

Rolling caches are refused: a rejected draft's write into a ring has
already evicted the slot it landed in. A linear cache rewinds by moving
``length`` back: the rejected rows stay in the cache, masked by the
causal read at ``pos + t``, until the next verify (which starts at the
rewound position) overwrites them, scales included for an int8 cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models.decoding import (
    KVCache,
    StackedDecodeParams,
    forward_with_cache,
    gumbel_noise,
    make_generator,
    quantize_decode_params,
)
from kubeflow_tpu_torch.models.transformer import LMConfig


def ngram_propose(tokens: torch.Tensor, count: int, *, n: int,
                  k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Draft from a token buffer in one vectorised pass. ``tokens`` (L,)
    with the first ``count`` entries valid (prompt + emitted so far); the
    trailing ``n`` tokens are the context. Returns (draft (k,), found 0-d
    bool), both on the buffer's device: the ``k`` tokens after the most
    recent EARLIER occurrence of the context, or ``k`` repeats of the
    last token when there is none (a junk draft is just rejected).

    Position j matches iff ``tokens[j - i] == tokens[count - 1 - i]`` for
    all i < n; the roll wraps junk into j < i, which the ``j >= n - 1``
    bound masks, and ``j <= count - 2`` keeps the context's own
    occurrence and the stale tail out. The draft slice starts at
    ``j + 1``, clamped so that it fits the buffer (it may read the stale
    tail, as the reference's ``dynamic_slice`` does)."""
    length = tokens.shape[0]
    idx = torch.arange(length, device=tokens.device)
    match = torch.ones(length, dtype=torch.bool, device=tokens.device)
    for i in range(n):
        context = tokens[max(count - 1 - i, 0)]
        match &= torch.roll(tokens, i) == context
    match &= (idx >= n - 1) & (idx <= count - 2)
    j = torch.where(match, idx, torch.full_like(idx, -1)).max()
    found = j >= 0
    start = torch.where(found, j + 1, torch.zeros_like(j)).clamp(
        max=length - k)
    draft = tokens[start + torch.arange(k, device=tokens.device)]
    last = tokens[count - 1]
    return torch.where(found, draft, last.expand(k)), found


class NGramProposer:
    """Host-side n-gram lookup for the streaming engine: the rule of
    :func:`ngram_propose` with backoff, the longest context (``n`` down to
    1) that has an earlier occurrence wins. Vectorised numpy over the
    history; the engine calls it once per slot per verify cycle."""

    def __init__(self, n: int = 3, k: int = 8):
        if n < 1 or k < 1:
            raise ValueError("ngram n and draft k must be >= 1")
        self.n = n
        self.k = k

    def propose(self, tokens) -> list[int]:
        """``tokens``: the full history (prompt + generated). Returns
        exactly ``k`` draft tokens (last-token repeats when no context
        matches)."""
        arr = np.asarray(tokens, dtype=np.int64)
        count = arr.shape[0]
        fill = [int(arr[-1])] * self.k
        for n in range(min(self.n, count - 1), 0, -1):
            match = np.ones(count, bool)
            for i in range(n):
                match &= np.roll(arr, i) == arr[count - 1 - i]
            match[:n - 1] = False
            match[count - 1:] = False
            hits = np.nonzero(match)[0]
            if hits.size:
                j = int(hits[-1])
                draft = [int(t) for t in arr[j + 1:j + 1 + self.k]]
                return draft + fill[len(draft):]
        return fill


@dataclasses.dataclass
class SpecStats:
    """What a speculative run did: verifies, drafted and accepted draft
    tokens, and the tokens returned."""

    verify_calls: int
    drafted: int
    accepted: int
    tokens: int

    @property
    def accept_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def tokens_per_verify(self) -> float:
        return self.tokens / self.verify_calls if self.verify_calls else 0.0


class NoiseQueue:
    """A request's Gumbel rows for the decode tokens it has yet to emit,
    in ``generate``'s order. ``window(t)`` tops the queue up to ``t`` rows
    (each drawn alone, shape ``(1, vocab)`` as ``generate`` draws it,
    never past ``budget`` rows in all) and returns ``t`` rows, zeros past
    the budget; ``pop(m)`` drops the ``m`` rows the emitted tokens used.
    """

    def __init__(self, gen: torch.Generator, vocab: int, budget: int,
                 device):
        self.gen = gen
        self.vocab = vocab
        self.budget = budget
        self.device = device
        self.drawn = 0
        self.rows: list[torch.Tensor] = []

    def window(self, t: int) -> torch.Tensor:
        while len(self.rows) < t and self.drawn < self.budget:
            self.rows.append(gumbel_noise(self.gen, (1, self.vocab),
                                          self.device))
            self.drawn += 1
        rows = self.rows[:t]
        if len(rows) < t:
            rows = rows + [torch.zeros((t - len(rows), self.vocab),
                                       device=self.device)]
        return torch.cat(rows)

    def pop(self, m: int) -> None:
        del self.rows[:m]


@torch.no_grad()
def speculative_generate(cfg: LMConfig, params: dict[str, Any], prompt,
                         max_new_tokens: int, temperature: float = 0.0,
                         rng=None, draft: int = 8, ngram: int = 3,
                         quantize_cache: bool = False,
                         quantize_weights: bool = False,
                         return_stats: bool = False, device=None):
    """``generate`` with n-gram speculation. ``prompt`` must be (1, P):
    acceptance lengths differ per sequence, so batching belongs to the
    serving engine (``verify_step``). Returns (1, max_new_tokens) int32
    equal to ``generate(cfg, params, prompt, max_new_tokens, temperature,
    rng, ...)`` wherever the verify chunk and the single-token step round
    alike (module docstring); ``rng`` is an int seed or a
    ``torch.Generator``. ``return_stats=True`` also returns a
    :class:`SpecStats`.

    Each verify is one ``forward_with_cache`` of ``draft + 1`` tokens
    from the accepted prefix (``cache.length`` rewound there) plus a
    vectorised n-gram search over the token buffer on the device; the
    host loop reads back one scalar a verify, the accepted count."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if isinstance(params, StackedDecodeParams):
        raise ValueError("speculative_generate takes the raw training params "
                         "(the verify chunk runs the unrolled path)")
    if cfg.moe_experts and cfg.moe_router == "expert_choice":
        raise NotImplementedError(
            "expert-choice routing is not causal - autoregressive decode "
            "requires topk routing")
    if temperature > 0.0 and rng is None:
        raise ValueError("temperature > 0 samples from the categorical "
                         "distribution; pass rng (an int seed or a "
                         "torch.Generator)")
    if draft < 1 or ngram < 1:
        raise ValueError("draft and ngram must be >= 1")
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, p = prompt.shape
    if b != 1:
        raise ValueError(
            f"speculative decoding is per-sequence (got batch {b}); batched "
            "serving drafts ride models.serving.verify_step")
    total = p + max_new_tokens
    if cfg.attn_window is not None and cfg.attn_window < total:
        raise ValueError(
            "speculative decoding requires a linear KV cache: a rejected "
            "draft's write into a rolling ring has already evicted the slot "
            f"it landed in (window {cfg.attn_window} < prompt+new {total})")
    if quantize_weights:
        params = quantize_decode_params(cfg, params)

    # Verify chunks overshoot the accepted prefix by up to `draft` rows;
    # the capacity absorbs the overshoot.
    cache = KVCache.init(cfg, 1, p + max_new_tokens - 1 + draft,
                         quantized=quantize_cache, device=dev)
    logits, cache = forward_with_cache(cfg, params, prompt, cache,
                                       last_logits_only=True, device=dev)
    gen = make_generator(rng, dev) if temperature > 0.0 else None

    def sample(rows, noise):
        if gen is None:
            return torch.argmax(rows, dim=-1).to(torch.int32)
        return torch.argmax(rows / temperature + noise,
                            dim=-1).to(torch.int32)

    first_noise = (gumbel_noise(gen, (1, cfg.vocab), dev)
                   if gen is not None else None)
    first = sample(logits[:, -1], first_noise)
    if max_new_tokens == 1:
        out = first[:, None]
        return (out, SpecStats(0, 0, 0, 1)) if return_stats else out

    queue = (NoiseQueue(gen, cfg.vocab, max_new_tokens - 1, dev)
             if gen is not None else None)
    t = draft + 1
    buf = torch.zeros(p + max_new_tokens + draft, dtype=torch.int32,
                      device=dev)
    buf[:p] = prompt[0].to(torch.int32)
    buf[p] = first[0]
    count, emitted, verifies, accepted = p + 1, 1, 0, 0
    while emitted < max_new_tokens:
        drafted, _ = ngram_propose(buf, count, n=ngram, k=draft)
        chunk = torch.cat([buf[count - 1:count], drafted])[None].long()
        # Rewind: the rows past the accepted prefix are masked by the
        # causal read and overwritten by this chunk.
        cache = dataclasses.replace(cache, length=count - 1)
        logits, cache = forward_with_cache(cfg, params, chunk, cache,
                                           device=dev)
        cand = sample(logits[0], queue.window(t) if queue else None)
        a = int(torch.cumprod((cand[:draft] == drafted).to(torch.int32),
                              dim=0).sum())
        take = min(a + 1, max_new_tokens - emitted)
        buf[count:count + t] = cand
        if queue:
            queue.pop(take)
        count += take
        emitted += take
        verifies += 1
        accepted += min(a, take)
    out = buf[p:p + max_new_tokens][None]
    if return_stats:
        return out, SpecStats(verify_calls=verifies,
                              drafted=verifies * draft, accepted=accepted,
                              tokens=max_new_tokens)
    return out


__all__ = ["ngram_propose", "NGramProposer", "SpecStats", "NoiseQueue",
           "speculative_generate"]

"""Continuous-batching decode: many requests share one lockstep step.

The counterpart of ``kubeflow_tpu/models/serving.py``. A fixed number of
decode SLOTS step in lockstep while requests flow through them: a slot
that finishes is refilled from the queue without stopping the others.

- ``BatchState`` holds a (layers, B, Hkv, capacity, hd) cache pair plus
  per-slot tensors on the device: ``pos`` (next global position),
  ``last`` (last sampled token), ``active`` and ``temp``. The decode
  step updates them IN PLACE (the reference donates them).
- The decode step is ``generate``'s single-token step with per-slot
  positions: per-row rope offsets, per-row cache writes, and attention
  with a (B,) position vector; inactive slots compute values that the
  state update masks out.
- Prefill reuses ``forward_with_cache`` on a B=1 cache of the SAME
  capacity and splices it into the slot.
- Sampling: each sampled request carries its own ``torch.Generator``
  (from its integer seed) and draws Gumbel noise for its first token at
  prefill and one row per decode step, in ``generate``'s order, so a
  request's tokens equal ``generate(..., rng=seed)``'s.

- Speculative verification: :func:`verify_step` scores a (B, T) chunk
  per slot (the pending token and T - 1 drafts) and writes its K/V in
  place at rows ``pos[b] .. pos[b] + T - 1``; :func:`commit_verify`
  then advances ``pos``/``last`` by what the host accepted. Sampled
  slots bring one Gumbel row per position, (B, T, vocab), from their
  request's queue (``models/speculative.py`` ``NoiseQueue``) in place of
  the reference's per-slot key windows.

Parity contract: every request's output equals single-request
``generate`` on the same device and dtype; slot assignment, admission
order, neighbours and chunk size do not change it. MoE models are
refused with ``NotImplementedError`` (the engine then serves them
through serialized ``generate``), as in the reference.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models.decoding import (
    DECODE_BLOCK,
    KVCache,
    _fused_qkv,
    _fused_step_wanted,
    _mm,
    _params_device,
    _quantize_rows,
    attention_kernel_wanted,
    embed_tokens,
    forward_with_cache,
    fuse_qkv_params,
    gumbel_noise,
    kernel_attention,
    make_generator,
)
from kubeflow_tpu_torch.models.transformer import LMConfig, gelu, rms_norm
from kubeflow_tpu_torch.ops.attention import apply_rope
from kubeflow_tpu_torch.ops.decode_attention import decode_attention_reference

NEG_INF = -1e30


@dataclasses.dataclass
class BatchState:
    """Per-slot decode state. ``k``/``v``: (L, B, Hkv, capacity, hd);
    ``pos``: (B,) int32 next global position; ``last``: (B,) int32 the
    token to feed next; ``active``: (B,) bool; ``temp``: (B,) f32
    sampling temperature (0 = greedy). ``k_scale``/``v_scale`` (int8
    slots only): (L, B, Hkv, capacity, 1) f32 per-row absmax scales."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    last: torch.Tensor
    active: torch.Tensor
    temp: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def init(cls, cfg: LMConfig, max_batch: int, capacity: int,
             rolling: bool = False, quantized: bool = False, device=None):
        dev = resolve_device(device)
        if rolling:
            if cfg.attn_window is None:
                raise ValueError("rolling slots require cfg.attn_window")
            capacity = min(cfg.attn_window, capacity)
        else:
            capacity = -(-capacity // DECODE_BLOCK) * DECODE_BLOCK
        shape = (cfg.layers, max_batch, cfg.num_kv_heads, capacity,
                 cfg.head_dim)
        kv_dtype = torch.int8 if quantized else cfg.dtype

        def zeros(shp, dtype):
            return torch.zeros(shp, dtype=dtype, device=dev)

        return cls(
            k=zeros(shape, kv_dtype), v=zeros(shape, kv_dtype),
            pos=zeros((max_batch,), torch.int32),
            last=zeros((max_batch,), torch.int32),
            active=zeros((max_batch,), torch.bool),
            temp=zeros((max_batch,), torch.float32),
            k_scale=zeros(shape[:-1] + (1,), torch.float32)
            if quantized else None,
            v_scale=zeros(shape[:-1] + (1,), torch.float32)
            if quantized else None,
        )


def check_request_contract(prompt, max_new_tokens: int, temperature: float,
                           rng) -> list[int]:
    """The admission contract every engine shares: integer tokens, a
    non-empty prompt, a real budget, and rng-required-iff-sampling.
    Returns the normalised prompt."""
    prompt = list(map(int, prompt))
    if not prompt:
        raise ValueError("empty prompt")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if temperature > 0.0 and rng is None:
        raise ValueError("temperature > 0 samples from the categorical "
                         "distribution; pass rng (an int seed or a "
                         "torch.Generator)")
    return prompt


def _sample(logits, temp, noise=None):
    """(B, vocab) logits -> (B,) int32 tokens: per-row greedy (temp 0),
    or argmax(logits / temp + noise) with the row's Gumbel ``noise``
    (B, vocab) — categorical sampling at the row's temperature."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if noise is None:
        return greedy
    hot = temp > 0.0
    safe = torch.where(hot, temp, torch.ones_like(temp))[:, None]
    drawn = torch.argmax(logits / safe + noise, dim=-1).to(torch.int32)
    return torch.where(hot, drawn, greedy)


def splice_slot(state: BatchState, slot: int, cache: KVCache, first,
                temp: float) -> BatchState:
    """Copy a B=1 cache (payload + scales) into ``slot`` at position
    ``cache.length``: the shared tail of every prefill variant. The
    copy leaves ``cache`` itself untouched."""
    state.k[:, slot] = cache.k[:, 0]
    state.v[:, slot] = cache.v[:, 0]
    if state.quantized:
        state.k_scale[:, slot] = cache.k_scale[:, 0]
        state.v_scale[:, slot] = cache.v_scale[:, 0]
    state.pos[slot] = cache.length
    state.last[slot] = first
    state.active[slot] = True
    state.temp[slot] = float(temp)
    return state


def _write_row(cache_layer, new, pos) -> None:
    """cache_layer (B, Hkv, cap, hd) <- new (B, Hkv, 1, hd) at per-row
    positions ``pos`` (B,), in place."""
    rows = torch.arange(cache_layer.shape[0], device=cache_layer.device)
    cache_layer[rows, :, pos.long()] = new[:, :, 0]


def _batched_pos_attention(cfg: LMConfig, q, ck, cv, pos, rolling=False,
                           ks=None, vs=None):
    """Single-token attention with PER-SLOT positions: flash-decode where
    :func:`attention_kernel_wanted` says so, else the dense masked read
    (linear: cols <= pos[b] within the window; rolling: the ring
    mapping)."""
    if attention_kernel_wanted(cfg, ck.shape[2], ks is not None, rolling, q):
        return kernel_attention(cfg, q, ck, cv, pos, rolling=rolling,
                                ks=ks, vs=vs)
    return decode_attention_reference(
        q, ck, cv, pos, window=None if rolling else cfg.attn_window,
        k_scale=ks, v_scale=vs, rolling=rolling)


@torch.no_grad()
def decode_step(cfg: LMConfig, params: dict[str, Any], state: BatchState,
                noise=None, rolling: bool = False):
    """One lockstep token for every slot: greedy, or per-slot sampling
    with ``noise`` (B, vocab) Gumbel rows. Updates ``state`` in place
    and returns (state, (B,) tokens); inactive slots' tokens are
    garbage the caller ignores."""
    if cfg.moe_experts:
        raise NotImplementedError("continuous batching serves dense-FFN "
                                  "models (MoE decode runs through "
                                  "generate())")
    b = state.last.shape[0]
    emb = params["embed"]["embedding"]
    x = embed_tokens(cfg, emb, state.last.long()[:, None])  # (B, 1, D)
    hq, hkv, hd = cfg.heads, cfg.num_kv_heads, cfg.head_dim
    capacity = state.k.shape[3]
    # Ring slots wrap; linear writes clamp at the edge like the
    # reference's dynamic_update_slice (admission keeps live slots in).
    wpos = (torch.remainder(state.pos, capacity) if rolling
            else state.pos.clamp(max=capacity - 1))
    for i in range(cfg.layers):
        blk = params[f"block_{i}"]
        h = rms_norm(blk["RMSNorm_0"]["scale"], x)
        fused = (_fused_qkv(cfg, blk, h, state.pos)
                 if _fused_step_wanted(h) else None)
        if fused is not None:
            q, k, v = fused
        else:
            def proj(name, n):
                y = _mm(h, blk[name]["kernel"], cfg.dtype).to(cfg.dtype)
                return y.reshape(b, 1, n, hd).transpose(1, 2)

            q = apply_rope(proj("q_proj", hq), offset=state.pos)
            k = apply_rope(proj("k_proj", hkv), offset=state.pos)
            v = proj("v_proj", hkv)
        ks_buf = vs_buf = None
        if state.quantized:
            k, k_s = _quantize_rows(k)
            v, v_s = _quantize_rows(v)
            ks_buf, vs_buf = state.k_scale[i], state.v_scale[i]
            _write_row(ks_buf, k_s, wpos)
            _write_row(vs_buf, v_s, wpos)
        _write_row(state.k[i], k, wpos)
        _write_row(state.v[i], v, wpos)
        out = _batched_pos_attention(cfg, q, state.k[i], state.v[i],
                                     state.pos, rolling=rolling,
                                     ks=ks_buf, vs=vs_buf)
        out = out.transpose(1, 2).reshape(b, 1, cfg.dim)
        x = _mm(out, blk["proj"]["kernel"], cfg.dtype, residual=x)
        h = rms_norm(blk["RMSNorm_1"]["scale"], x)
        h = gelu(_mm(h, blk["up"]["kernel"], cfg.dtype).to(cfg.dtype))
        x = _mm(h, blk["down"]["kernel"], cfg.dtype, residual=x)
    x = rms_norm(params["final_norm"]["scale"], x)
    logits = _mm(x.to(cfg.dtype), emb, cfg.dtype, transpose_w=True)
    nxt = _sample(logits[:, -1], state.temp, noise)
    state.pos += state.active.to(torch.int32)
    state.last.copy_(torch.where(state.active, nxt, state.last))
    return state, nxt


def _batched_chunk_attention(cfg: LMConfig, q, ck, cv, pos, ks=None,
                             vs=None):
    """Multi-token masked read with PER-SLOT base positions, the verify
    step's ``_cached_attention``: q (B, H, T, hd) holds T consecutive
    tokens per row from global position ``pos[b]``; ck/cv (B, Hkv, cap,
    hd) already hold the chunk's writes. Row (b, t) attends to cols <=
    pos[b] + t (within the window); ``ks``/``vs`` dequantise an int8
    cache per row. Operands in the compute dtype, f32 accumulation."""
    b, h, t, hd = q.shape
    hkv = ck.shape[1]
    compute = q.dtype
    qg = q.reshape(b, hkv, h // hkv, t, hd).float()
    s = torch.einsum("bkgtd,bkld->bkgtl", qg,
                     ck.to(compute).float()) * hd ** -0.5
    if ks is not None:
        s = s * ks[..., 0][:, :, None, None, :]
    rows = (pos.long()[:, None]
            + torch.arange(t, device=q.device)[None, :])[:, None, None, :,
                                                         None]
    cols = torch.arange(ck.shape[2], device=q.device)
    keep = cols <= rows
    if cfg.attn_window is not None:
        keep = keep & (cols > rows - cfg.attn_window)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    if vs is not None:
        w = w * vs[..., 0][:, :, None, None, :]
    out = torch.einsum("bkgtl,bkld->bkgtd", w.to(compute).float(),
                       cv.to(compute).float())
    return out.reshape(b, h, t, hd).to(q.dtype)


def _write_rows(cache_layer, new, start) -> None:
    """cache_layer (B, Hkv, cap, hd) <- new (B, Hkv, T, hd) at rows
    ``start[b] .. start[b] + T - 1``, in place."""
    b, _, t, _ = new.shape
    rows = torch.arange(b, device=cache_layer.device)[:, None]
    cols = start.long()[:, None] + torch.arange(t, device=start.device)
    cache_layer[rows, :, cols] = new.transpose(1, 2)


@torch.no_grad()
def verify_step(cfg: LMConfig, params: dict[str, Any], state: BatchState,
                tokens, noise=None, rolling: bool = False):
    """Score a (B, T) chunk per slot in one forward: the speculative
    serving step. ``tokens[b, 0]`` is the slot's pending token
    (``state.last``) and ``tokens[b, 1:]`` its T - 1 drafts; ``noise``
    (B, T, vocab) holds each position's Gumbel row for sampled slots
    (zeros elsewhere; greedy slots ignore it). Returns ``(state, cand (B,
    T))``: ``cand[b, i]`` is the token the model emits after ``tokens[b,
    :i + 1]``, the value a chain of i + 1 ``decode_step``s would sample.
    The chunk's K/V are written in place at rows ``pos[b] .. pos[b] + T -
    1``; ``pos`` and ``last`` do NOT move: the host decides the accepted
    prefix and :func:`commit_verify` advances them (rows past it are
    masked by the causal read and overwritten by the next verify, which
    starts at the committed position).

    Linear slots only: a rolling ring cannot rewind a rejected write."""
    if cfg.moe_experts:
        raise NotImplementedError(
            "continuous batching serves dense-FFN models (MoE decode runs "
            "through generate())")
    if rolling:
        raise ValueError("verify_step requires linear slots (a rolling ring "
                         "cannot rewind a rejected draft's write)")
    tokens = torch.as_tensor(tokens, device=state.k.device).long()
    b, t = tokens.shape
    emb = params["embed"]["embedding"]
    x = embed_tokens(cfg, emb, tokens)  # (B, T, D)
    hq, hkv, hd = cfg.heads, cfg.num_kv_heads, cfg.head_dim
    # Inactive slots' stale positions are clamped so their (ignored)
    # writes stay inside the buffer, as dynamic_update_slice clamps.
    wpos = state.pos.clamp(max=state.k.shape[3] - t)
    for i in range(cfg.layers):
        blk = params[f"block_{i}"]
        h = rms_norm(blk["RMSNorm_0"]["scale"], x)

        def proj(name, n):
            y = _mm(h, blk[name]["kernel"], cfg.dtype).to(cfg.dtype)
            return y.reshape(b, t, n, hd).transpose(1, 2)

        q = apply_rope(proj("q_proj", hq), offset=state.pos)
        k = apply_rope(proj("k_proj", hkv), offset=state.pos)
        v = proj("v_proj", hkv)
        ks_buf = vs_buf = None
        if state.quantized:
            k, k_s = _quantize_rows(k)
            v, v_s = _quantize_rows(v)
            ks_buf, vs_buf = state.k_scale[i], state.v_scale[i]
            _write_rows(ks_buf, k_s, wpos)
            _write_rows(vs_buf, v_s, wpos)
        _write_rows(state.k[i], k, wpos)
        _write_rows(state.v[i], v, wpos)
        out = _batched_chunk_attention(cfg, q, state.k[i], state.v[i],
                                       state.pos, ks=ks_buf, vs=vs_buf)
        out = out.transpose(1, 2).reshape(b, t, cfg.dim)
        x = _mm(out, blk["proj"]["kernel"], cfg.dtype, residual=x)
        h = rms_norm(blk["RMSNorm_1"]["scale"], x)
        h = gelu(_mm(h, blk["up"]["kernel"], cfg.dtype).to(cfg.dtype))
        x = _mm(h, blk["down"]["kernel"], cfg.dtype, residual=x)
    x = rms_norm(params["final_norm"]["scale"], x)
    logits = _mm(x.to(cfg.dtype), emb, cfg.dtype, transpose_w=True)
    # One row per draw: generate()'s sampling at the slot's temperature.
    flat_noise = None if noise is None else noise.reshape(b * t, -1)
    cand = _sample(logits.reshape(b * t, -1),
                   state.temp.repeat_interleave(t), flat_noise)
    return state, cand.reshape(b, t)


def commit_verify(state: BatchState, accepted, last) -> BatchState:
    """Advance per-slot positions by the host-decided ``accepted`` counts
    ((B,) int, 0 for untouched slots) and point ``last`` at the newest
    emitted token, in place: the other half of the verify/commit pair."""
    accepted = torch.as_tensor(accepted, dtype=torch.int32,
                               device=state.pos.device)
    last = torch.as_tensor(last, dtype=torch.int32, device=state.pos.device)
    state.pos += accepted
    state.last.copy_(torch.where(accepted > 0, last, state.last))
    return state


def decode_chunk(cfg: LMConfig, params: dict[str, Any], state: BatchState,
                 noises, rolling: bool = False):
    """``len(noises)`` lockstep tokens (a Python loop over
    :func:`decode_step`; each entry is that step's (B, vocab) noise or
    None). Returns (state, (steps, B) tokens)."""
    toks = []
    for noise in noises:
        state, nxt = decode_step(cfg, params, state, noise, rolling=rolling)
        toks.append(nxt)
    return state, torch.stack(toks)


@torch.no_grad()
def prefill_slot(cfg: LMConfig, params: dict[str, Any], state: BatchState,
                 slot: int, prompt, temp: float, noise=None,
                 rolling: bool = False):
    """Admit ``prompt`` (1, P) into ``slot``: the B=1 prefill on a cache
    of the slot capacity and layout, spliced into the state. The first
    token samples at ``temp`` with ``noise`` (vocab,) when sampling.
    Returns (state, first token as a 0-d device tensor)."""
    capacity = state.k.shape[3]
    dev = state.k.device
    cache = KVCache.init(cfg, 1, capacity, rolling=rolling,
                         quantized=state.quantized, device=dev)
    logits, cache = forward_with_cache(cfg, params, prompt, cache,
                                       last_logits_only=True, device=dev)
    first = _sample_one(logits[:, -1], temp, noise)
    return splice_slot(state, slot, cache, first, temp), first


def _sample_one(logits_row, temp: float, noise):
    """(1, vocab) -> 0-d token at ``temp`` with (vocab,) ``noise``."""
    t = torch.full((1,), float(temp), device=logits_row.device)
    return _sample(logits_row, t, None if noise is None else noise[None])[0]


class ContinuousBatcher:
    """Queue + slot manager over :func:`prefill_slot` and
    :func:`decode_chunk`.

    >>> batcher = ContinuousBatcher(cfg, params, max_batch=4,
    ...                             max_len=2048)
    >>> rid = batcher.submit([1, 2, 3], max_new_tokens=64)
    >>> results = batcher.run()   # {rid: [tok, ...], ...}

    ``run()`` drains the queue: free slots admit queued prompts (one
    prefill each), then all active slots decode ``step_chunk`` tokens in
    lockstep, finishes and admissions happen at chunk boundaries, and
    the cycle repeats. Runs on the card unless ``device="cpu"``.
    """

    def __init__(self, cfg: LMConfig, params: dict[str, Any], max_batch: int,
                 max_len: int, eos_token: int | None = None,
                 step_chunk: int = 8, quantize_cache: bool = False,
                 device=None):
        if cfg.moe_experts:
            raise NotImplementedError(
                "continuous batching serves dense-FFN models (MoE decode "
                "runs through generate())")
        if step_chunk < 1:
            raise ValueError("step_chunk must be >= 1")
        self.device = resolve_device(device)
        if _params_device(params) != self.device:
            raise ValueError(f"params live on {_params_device(params)}, the "
                             f"batcher on {self.device}")
        self.cfg = cfg
        self.params = fuse_qkv_params(cfg, params, rows=max_batch)
        self.eos = eos_token
        self.step_chunk = step_chunk
        self.reserve_slack = step_chunk
        self.quantize_cache = quantize_cache
        self.rolling = (cfg.attn_window is not None
                        and cfg.attn_window < max_len)
        self.state = BatchState.init(cfg, max_batch, max_len,
                                     rolling=self.rolling,
                                     quantized=quantize_cache,
                                     device=self.device)
        self.capacity = self.state.k.shape[3]
        self.max_len = max_len
        self._queue: deque = deque()
        self._slots: list[dict | None] = [None] * max_batch
        self._results: dict[int, list[int]] = {}
        self._next_id = 0

    def _build_request(self, rid: int, prompt, max_new_tokens: int,
                       temperature: float, rng) -> dict:
        """Validate + assemble one request dict (shared with the
        streaming engine). Reads only immutable sizing attributes, so
        any thread may call it."""
        prompt = check_request_contract(prompt, max_new_tokens, temperature,
                                        rng)
        slack = 0 if self.rolling else self.reserve_slack
        limit = self.max_len if self.rolling else self.capacity
        if len(prompt) + max_new_tokens + slack > limit:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                + (f" + write slack ({slack})" if slack else "")
                + f" exceeds {'max_len' if self.rolling else 'capacity'} "
                f"{limit}")
        gen = (make_generator(rng, self.device) if temperature > 0.0
               else None)
        return {"id": rid, "prompt": prompt, "budget": max_new_tokens,
                "done": False, "temp": float(temperature), "gen": gen,
                "drawn": 0}

    def submit(self, prompt, max_new_tokens: int = 128,
               temperature: float = 0.0, rng=None) -> int:
        """Queue a request; ``rng`` (an int seed or a generator) is
        required iff ``temperature > 0``."""
        rid = self._next_id
        self._next_id += 1
        self._queue.append(self._build_request(rid, prompt, max_new_tokens,
                                               temperature, rng))
        return rid

    # ---------------------------------------------------- internals
    def _first_noise(self, req: dict):
        """The request's first-token noise row (vocab,), or None."""
        if req["gen"] is None:
            return None
        return gumbel_noise(req["gen"], (self.cfg.vocab,), self.device)

    def _prompt_tensor(self, tokens) -> torch.Tensor:
        return torch.tensor([tokens], dtype=torch.long, device=self.device)

    def _admit(self):
        # Keep admitting while there are free slots: a request that ends
        # AT prefill frees its slot for the next one in the same pass.
        while self._queue:
            free = next((i for i, s in enumerate(self._slots) if s is None),
                        None)
            if free is None:
                return
            req = self._queue.popleft()
            self.state, first = prefill_slot(
                self.cfg, self.params, self.state, free,
                self._prompt_tensor(req["prompt"]), req["temp"],
                self._first_noise(req), rolling=self.rolling)
            first = int(first)
            self._results[req["id"]] = [first]
            self._slots[free] = req
            self._check_done(req, first)
            if req["done"]:
                self._free(free)

    def _check_done(self, req: dict, token: int):
        if (len(self._results[req["id"]]) >= req["budget"]
                or (self.eos is not None and token == self.eos)):
            req["done"] = True

    def _free(self, slot: int):
        self._slots[slot] = None
        self.state.active[slot] = False

    def _chunk_noise(self) -> list:
        """Per step of the next chunk, the (B, vocab) Gumbel rows of the
        sampled slots (zeros elsewhere), or None when no slot samples.
        A request draws one row per decode token it still needs — its
        ``budget - 1`` draws, in ``generate``'s order."""
        noises = []
        for _ in range(self.step_chunk):
            rows = {}
            for slot, req in enumerate(self._slots):
                if (req is not None and req["gen"] is not None
                        and req["drawn"] < req["budget"] - 1):
                    rows[slot] = gumbel_noise(req["gen"], (self.cfg.vocab,),
                                              self.device)
                    req["drawn"] += 1
            if not rows:
                noises.append(None)
                continue
            noise = torch.zeros((len(self._slots), self.cfg.vocab),
                                device=self.device)
            for slot, row in rows.items():
                noise[slot] = row
            noises.append(noise)
        return noises

    def _decode(self):
        """One chunk for every slot; returns the (step_chunk, B) tokens
        on the host (the one synchronisation per chunk)."""
        self.state, toks = decode_chunk(self.cfg, self.params, self.state,
                                        self._chunk_noise(),
                                        rolling=self.rolling)
        return toks.cpu().tolist()

    def run(self) -> dict[int, list[int]]:
        """Drain queue + slots; returns {request id: generated tokens
        (first token included, eos included if hit)}."""
        self._admit()
        while any(s is not None for s in self._slots):
            for row in self._decode():
                for slot, req in enumerate(self._slots):
                    if req is None or req["done"]:
                        continue
                    token = int(row[slot])
                    self._results[req["id"]].append(token)
                    self._check_done(req, token)
            for slot, req in enumerate(self._slots):
                if req is not None and req["done"]:
                    self._free(slot)
            self._admit()
        return dict(self._results)

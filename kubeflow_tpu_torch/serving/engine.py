"""Streaming serving engine over the continuous batcher.

The counterpart of ``kubeflow_tpu/serving/engine.py``.
:class:`StreamingBatcher` keeps the batcher's slots, step and parity
contract and adds the serving mechanics:

- **Thread-fed bounded inbox**: callers submit through
  :meth:`~StreamingBatcher.submit_stream`; past ``max_pending`` waiting
  requests the engine sheds with :class:`QueueFull`. The scheduler
  thread is the only one touching device state; the lock guards exactly
  the handoff structures.
- **Prefill/decode interleaving**: at most ``prefill_per_cycle`` prompts
  are admitted per decode cycle, so a burst of prefills cannot stall
  every in-flight stream for their sum.
- **Prefix cache**: prefills are memoised by prompt tuple. A prompt that
  extends a cached prompt prefills only the suffix on top of the cached
  B=1 KV; an exact match samples from the cached last-position logits.
  The port writes caches in place, so an entry is CLONED before any
  prefill writes on top of it (the reference copies only before a
  donating chunk advance; here the suffix write would otherwise land in
  storage the entry shares with every later request).
- **Chunked prefill**: a prompt longer than ``prefill_chunk_tokens`` is
  prefilled one chunk per cycle.
- **Hot model swap**: :meth:`~_EngineBase.swap_params` stages new
  parameters; the scheduler applies them between cycles after the
  in-flight slots drain.
- **Self-speculative n-gram decoding** (opt-in, ``spec_ngram``): every
  active slot drafts ``spec_draft`` tokens from its own prompt and output
  (``models/speculative.py`` ``NGramProposer``) and ONE batched
  ``verify_step`` scores them all; each slot keeps its longest matching
  prefix plus the model's correction. A sampled request keeps a queue of
  Gumbel rows (``NoiseQueue``): a verify takes ``spec_draft + 1`` of
  them and pops the rows of the tokens it emitted, so its stream equals
  ``generate(rng=seed)``. Linear slots only.

:class:`GenerateFallbackEngine` serves the same interface through
serialized ``generate()`` calls for models the batcher refuses (MoE), one
request at a time, tokens still streamed to the sink and metered.

Sinks receive ``{"token": t}`` per generated token and a final
``{"done": True, "reason": ..., "tokens": [...], "cache_hit": ...}``.
Sink callbacks run on the scheduler thread and must not block.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable

import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models.decoding import (
    KVCache,
    forward_with_cache,
    fuse_qkv_params,
    generate,
)
from kubeflow_tpu_torch.models.serving import (
    BatchState,
    ContinuousBatcher,
    _sample_one,
    check_request_contract,
    commit_verify,
    prefill_slot,
    splice_slot,
    verify_step,
)
from kubeflow_tpu_torch.models.speculative import NGramProposer, NoiseQueue
from kubeflow_tpu_torch.models.transformer import LMConfig
from kubeflow_tpu_torch.obs.metrics import BucketHistogram
from kubeflow_tpu_torch.obs.profile import PhaseProfiler
from kubeflow_tpu_torch.obs.recorder import FlightRecorder

log = logging.getLogger(__name__)

Sink = Callable[[dict], None]


class QueueFull(RuntimeError):
    """Admission inbox is at capacity — shed, don't queue unbounded."""


@dataclasses.dataclass
class CacheEntry:
    """One memoised prefill: the B=1 KV cache after a prompt
    (slot-capacity layout) plus the last-position logits, so an exact
    prompt match samples its first token without touching the model."""

    cache: KVCache
    logits: torch.Tensor  # (1, vocab) f32


class PrefixCache:
    """LRU map prompt-tuple -> :class:`CacheEntry` with longest-prefix
    lookup. Only the scheduler thread reads or writes it; capacity
    bounds device memory (each entry pins one B=1 slot-capacity cache).
    """

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError("prefix cache capacity must be >= 1")
        self.capacity = capacity
        self._entries: OrderedDict[tuple, CacheEntry] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def lookup(self, prompt: tuple) -> tuple[CacheEntry | None, int]:
        """(entry, prefix length) for the LONGEST cached prompt that is a
        prefix of ``prompt``; (None, 0) on a miss."""
        best: tuple | None = None
        for key in self._entries:
            if (len(key) <= len(prompt) and prompt[:len(key)] == key
                    and (best is None or len(key) > len(best))):
                best = key
        if best is None:
            self.misses += 1
            return None, 0
        self.hits += 1
        self._entries.move_to_end(best)
        return self._entries[best], len(best)

    def put(self, prompt, entry: CacheEntry) -> None:
        key = tuple(prompt)
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


# ---------------------------------------------------------------------------
# Prefill variants (linear slots only: a ring's slot<->position mapping
# depends on the writer's history, so a cached ring is not spliceable).
# ---------------------------------------------------------------------------


def prefill_slot_keep(cfg: LMConfig, params, state: BatchState, slot: int,
                      prompt, temp: float, noise=None):
    """``prefill_slot``, also returning the B=1 cache and last-position
    logits so the caller can memoise the prefill."""
    dev = state.k.device
    cache = KVCache.init(cfg, 1, state.k.shape[3],
                         quantized=state.quantized, device=dev)
    logits, cache = forward_with_cache(cfg, params, prompt, cache,
                                       last_logits_only=True, device=dev)
    first = _sample_one(logits[:, -1], temp, noise)
    return (splice_slot(state, slot, cache, first, temp), first, cache,
            logits[:, -1])


def extend_slot(cfg: LMConfig, params, state: BatchState, slot: int,
                cache: KVCache, suffix, temp: float, noise=None):
    """Prefill only ``suffix`` on top of ``cache`` (which it writes in
    place: pass a private copy), splice into ``slot`` and return the
    extended cache for re-memoisation."""
    logits, cache = forward_with_cache(cfg, params, suffix, cache,
                                       last_logits_only=True,
                                       device=state.k.device)
    first = _sample_one(logits[:, -1], temp, noise)
    return (splice_slot(state, slot, cache, first, temp), first, cache,
            logits[:, -1])


def advance_cache(cfg: LMConfig, params, tokens, cache: KVCache):
    """One prefill chunk with no slot splice (written in place into
    ``cache``); returns the advanced cache + last-position logits."""
    logits, cache = forward_with_cache(cfg, params, tokens, cache,
                                       last_logits_only=True,
                                       device=cache.k.device)
    return cache, logits[:, -1]


def adopt_slot(state: BatchState, slot: int, cache: KVCache, logits,
               temp: float, noise=None):
    """Exact prompt match: no model work — sample the first token from
    the cached logits with THIS request's temperature/noise and copy the
    cached KV into the slot (the entry itself is not written)."""
    first = _sample_one(logits, temp, noise)
    return splice_slot(state, slot, cache, first, temp), first


# ---------------------------------------------------------------------------
# Engine base: the thread-safe handoff.
# ---------------------------------------------------------------------------


class _EngineBase:
    """Bounded inbox + staged-swap plumbing. The lock guards exactly the
    structures caller threads and the scheduler thread hand off through
    (``_inbox``, ``_pending_count``, ``_pending_params``, ``_rid``);
    everything else belongs to the scheduler thread."""

    def __init__(self, max_pending: int = 64, profiler=None, recorder=None):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.max_pending = max_pending
        self._lock = threading.Lock()
        self._wake = threading.Event()
        # Bounded by max_pending: _enqueue sheds before appending.
        self._inbox: deque = deque()
        self._pending_count = 0
        self._pending_params: Any | None = None
        self._rid = 0
        self.profiler = profiler if profiler is not None else PhaseProfiler()
        self.recorder = recorder if recorder is not None else FlightRecorder()
        # The full phase set is pre-created: readers iterate this dict
        # while the scheduler observes, so it never resizes (verify and
        # commit stay at zero outside speculative mode).
        self.cycle_seconds = {name: BucketHistogram() for name in
                              ("admit", "prefill", "decode", "verify",
                               "commit")}
        self.occupancy = 0
        self.slots_total = 0
        self.cycles_total = 0

    def _observe_phase(self, name: str, seconds: float) -> None:
        hist = self.cycle_seconds.get(name)
        if hist is not None:
            hist.observe(seconds)
        self.profiler.observe(name, seconds)

    def _record_cycle(self, phases: dict, queue_depth: int) -> None:
        if self.recorder is None or not phases:
            return
        self.cycles_total += 1
        self.recorder.record(
            "serve_cycle", cycle=self.cycles_total,
            phases={k: round(v, 6) for k, v in phases.items()},
            occupancy=self.occupancy, slots=self.slots_total,
            queue_depth=queue_depth, memory=self.profiler.watermark())

    def _enqueue(self, req: dict) -> int:
        with self._lock:
            if self._pending_count >= self.max_pending:
                raise QueueFull(
                    f"{self._pending_count} requests already waiting "
                    f"(max_pending={self.max_pending})")
            rid = self._rid
            self._rid += 1
            self._pending_count += 1
            req["id"] = rid
            self._inbox.append(req)
        self._wake.set()
        return rid

    def _take_inbox(self) -> list[dict]:
        with self._lock:
            taken = list(self._inbox)
            self._inbox.clear()
        return taken

    def _note_admitted(self) -> None:
        with self._lock:
            self._pending_count -= 1

    def _staged_params(self):
        with self._lock:
            return self._pending_params

    def _consume_staged(self, staged) -> None:
        """Clear the stage only if it still holds ``staged`` (a newer
        swap racing in wins)."""
        with self._lock:
            if self._pending_params is staged:
                self._pending_params = None

    def pending(self) -> int:
        """Requests submitted but not yet admitted to compute."""
        with self._lock:
            return self._pending_count

    def swap_params(self, new_params) -> None:
        """Stage new parameters; the scheduler re-points between cycles
        after draining in-flight slots. Latest stage wins."""
        with self._lock:
            self._pending_params = new_params
        self._wake.set()

    def wait_for_work(self, timeout: float) -> None:
        if self._wake.wait(timeout):
            self._wake.clear()

    def _emit(self, req: dict, event: dict) -> None:
        """A dead client must not kill the scheduler thread."""
        sink = req.get("sink")
        if sink is None:
            return
        try:
            sink(event)
        except Exception:
            log.exception("serving sink failed for request %s",
                          req.get("id"))


class StreamingBatcher(_EngineBase, ContinuousBatcher):
    """The continuous batcher as a streaming engine (module docstring has
    the design). Runs on the card unless ``device="cpu"``."""

    batched = True  # /v1/status: slots decode in lockstep

    def __init__(self, cfg: LMConfig, params, max_batch: int, max_len: int,
                 eos_token: int | None = None, step_chunk: int = 8,
                 quantize_cache: bool = False, prefill_per_cycle: int = 2,
                 max_pending: int = 64, prefix_cache_size: int = 8,
                 prefill_chunk_tokens: int | None = None,
                 spec_ngram: bool = False, spec_draft: int = 8,
                 spec_ngram_n: int = 3, spec_lookback: int = 4096,
                 profiler=None, recorder=None, device=None):
        ContinuousBatcher.__init__(
            self, cfg, params, max_batch, max_len, eos_token=eos_token,
            step_chunk=step_chunk, quantize_cache=quantize_cache,
            device=device)
        _EngineBase.__init__(self, max_pending=max_pending,
                             profiler=profiler, recorder=recorder)
        self.slots_total = max_batch
        if prefill_per_cycle < 1:
            raise ValueError("prefill_per_cycle must be >= 1")
        if spec_ngram and self.rolling:
            # A rejected draft's ring write has already evicted the slot
            # it landed in: there is nothing to rewind to.
            raise ValueError(
                "speculative decoding requires linear slots "
                "(cfg.attn_window makes this engine rolling)")
        self.spec_ngram = spec_ngram
        self.spec_draft = spec_draft
        self.spec_ngram_n = spec_ngram_n
        # The proposer scans at most this many trailing history tokens a
        # slot a cycle, so host work does not grow with every token.
        self.spec_lookback = spec_lookback
        self.spec_verifies_total = 0
        self.spec_drafted_total = 0
        self.spec_accepted_total = 0
        if spec_ngram:
            self._proposer = NGramProposer(n=spec_ngram_n, k=spec_draft)
            # Verify chunks write up to spec_draft rows past the accepted
            # prefix; the admission bound reserves the overshoot.
            self.reserve_slack = max(self.step_chunk, spec_draft)
        if prefill_chunk_tokens is not None:
            if prefill_chunk_tokens < 1:
                raise ValueError("prefill_chunk_tokens must be >= 1")
            if self.rolling:
                raise ValueError(
                    "chunked prefill requires linear slots "
                    "(cfg.attn_window makes this engine rolling)")
        self.prefill_per_cycle = prefill_per_cycle
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self._partial: dict | None = None
        self.chunked_admissions_total = 0
        self.swaps_total = 0
        self.draining = False
        self.prefix_cache = (None if self.rolling
                             else PrefixCache(prefix_cache_size))

    # ------------------------------------------------------ submission
    def submit(self, *args, **kwargs):
        raise RuntimeError(
            "StreamingBatcher serves streams; use submit_stream()")

    def run(self):
        raise RuntimeError(
            "StreamingBatcher serves streams; the Scheduler drives "
            "step_cycle() (tests can use drain())")

    def submit_stream(self, prompt, sink: Sink, max_new_tokens: int = 128,
                      temperature: float = 0.0, rng=None) -> int:
        """Thread-safe streaming submit: validates like the batch
        ``submit``, attaches ``sink`` and queues for the scheduler.
        Raises :class:`QueueFull` when the inbox is at capacity."""
        req = self._build_request(-1, prompt, max_new_tokens, temperature,
                                  rng)
        req["sink"] = sink
        return self._enqueue(req)

    # ------------------------------------------------------ scheduling
    def step_cycle(self) -> bool:
        """One scheduler cycle: move the inbox, apply a staged swap once
        the slots drained, admit up to ``prefill_per_cycle`` prompts, then
        one decode chunk for every active slot. False when fully idle."""
        with self.profiler.activate() as phases:
            worked = self._cycle()
        self.occupancy = sum(1 for s in self._slots if s is not None)
        if worked:
            self._record_cycle(phases, self.pending())
        return worked

    def _cycle(self) -> bool:
        admit_started = time.monotonic()
        admitted = False
        for req in self._take_inbox():
            self._queue.append(req)
            admitted = True
        if admitted:
            self._observe_phase("admit", time.monotonic() - admit_started)
        staged = self._staged_params()
        if staged is not None:
            self.draining = True
            if not any(s is not None for s in self._slots):
                with self.profiler.phase("swap"):
                    self.params = fuse_qkv_params(self.cfg, staged,
                                                  rows=len(self._slots))
                    self._consume_staged(staged)
                    if self.prefix_cache is not None:
                        # Cached KV came from the OLD weights.
                        self.prefix_cache.clear()
                    if self._partial is not None:
                        self._restart_partial()
                    self.swaps_total += 1
                    self.draining = False
        else:
            started = time.monotonic()
            if self._admit_capped():
                self._observe_phase("prefill", time.monotonic() - started)
        if not any(s is not None for s in self._slots):
            with self._lock:
                busy = (bool(self._queue) or bool(self._inbox)
                        or self._pending_params is not None)
            return busy or self._partial is not None
        started = time.monotonic()
        if self.spec_ngram:
            self._spec_decode_cycle()
        else:
            for row in self._decode():
                for slot, req in enumerate(self._slots):
                    if req is None or req["done"]:
                        continue
                    token = int(row[slot])
                    self._results[req["id"]].append(token)
                    self._emit(req, {"token": token})
                    self._check_done(req, token)
        self._observe_phase("decode", time.monotonic() - started)
        for slot, req in enumerate(self._slots):
            if req is not None and req["done"]:
                self._finish(req)
                self._free(slot)
        return True

    # ------------------------------------------- speculative decoding
    def _noise_queue(self, req: dict) -> NoiseQueue:
        """The request's queue of decode-token noise rows (its budget - 1
        draws, in ``generate``'s order), made at its first verify."""
        if "noise_q" not in req:
            req["noise_q"] = NoiseQueue(req["gen"], self.cfg.vocab,
                                        req["budget"] - 1, self.device)
        return req["noise_q"]

    def _spec_decode_cycle(self) -> None:
        """One speculative verify for every active slot: the host proposer
        drafts per-slot continuations from prompt + emitted history, ONE
        batched ``verify_step`` scores ``spec_draft + 1`` positions a
        slot, and each slot keeps its longest matching prefix plus the
        model's correction (at least one token a cycle). A sampled slot's
        noise rows come from its queue; only the emitted tokens' rows are
        popped, the rest wait for the next verify."""
        verify_started = time.monotonic()
        t = self.spec_draft + 1
        rows, drafts, noise = [], [], None
        for slot, req in enumerate(self._slots):
            if req is None or req["done"]:
                rows.append([0] * t)
                drafts.append(None)
                continue
            emitted_toks = self._results[req["id"]]
            keep = self.spec_lookback
            if len(emitted_toks) >= keep:
                history = emitted_toks[-keep:]
            else:
                history = (req["prompt"][len(emitted_toks) - keep:]
                           + emitted_toks)
            draft = self._proposer.propose(history)
            rows.append([history[-1]] + draft)
            drafts.append(draft)
            if req["gen"] is not None:
                if noise is None:
                    noise = torch.zeros((len(self._slots), t, self.cfg.vocab),
                                        device=self.device)
                noise[slot] = self._noise_queue(req).window(t)
        tokens = torch.tensor(rows, dtype=torch.long, device=self.device)
        self.state, cand = verify_step(self.cfg, self.params, self.state,
                                       tokens, noise)
        cand = cand.cpu().tolist()   # (B, t): the one synchronisation
        # verify = draft build + the batched scoring (host-synced); the
        # accept/emit loop below rides the decode total.
        self._observe_phase("verify", time.monotonic() - verify_started)
        accepted = [0] * len(self._slots)
        lasts = [0] * len(self._slots)
        self.spec_verifies_total += 1
        for slot, req in enumerate(self._slots):
            if req is None or req["done"]:
                continue
            draft, row = drafts[slot], cand[slot]
            match = 0
            while match < self.spec_draft and row[match] == draft[match]:
                match += 1
            self.spec_drafted_total += self.spec_draft
            emitted = 0
            for token in row[:match + 1]:
                self._results[req["id"]].append(token)
                self._emit(req, {"token": token})
                emitted += 1
                self._check_done(req, token)
                if req["done"]:
                    break
            if req["gen"] is not None:
                self._noise_queue(req).pop(emitted)
            accepted[slot] = emitted
            lasts[slot] = row[emitted - 1]
            # Accepted drafts among what was emitted: a cycle cut short by
            # eos or the budget emitted matching drafts only.
            self.spec_accepted_total += min(emitted, match)
        commit_started = time.monotonic()
        self.state = commit_verify(self.state, accepted, lasts)
        self._observe_phase("commit", time.monotonic() - commit_started)

    def _admit_capped(self) -> int:
        admitted = 0
        # The in-flight chunked prefill advances first, then fresh
        # admissions fill the rest of the cycle's prefill budget.
        if self._partial is not None:
            self._advance_partial()
            admitted += 1
        deferred = []
        while self._queue and admitted < self.prefill_per_cycle:
            head = self._queue[0]
            if (self.prefill_chunk_tokens is not None
                    and len(head["prompt"]) > self.prefill_chunk_tokens):
                self._queue.popleft()
                if self._partial is None:
                    self._start_partial(head)
                    admitted += 1
                else:
                    # One chunking prompt at a time; short prompts behind
                    # it keep flowing, relative order preserved.
                    deferred.append(head)
                continue
            free = next((i for i, s in enumerate(self._slots) if s is None),
                        None)
            if free is None:
                break
            req = self._queue.popleft()
            self._note_admitted()
            first = self._prefill_into(free, req)
            admitted += 1
            self._place(free, req, first)
        for req in reversed(deferred):
            self._queue.appendleft(req)
        return admitted

    def _place(self, slot: int, req: dict, first: int) -> None:
        self._results[req["id"]] = [first]
        self._slots[slot] = req
        self._emit(req, {"token": first})
        self._check_done(req, first)
        if req["done"]:
            self._finish(req)
            self._free(slot)

    # ------------------------------------------- chunked prefill path
    def _fresh_partial_cache(self) -> KVCache:
        return KVCache.init(self.cfg, 1, self.state.k.shape[3],
                            quantized=self.state.quantized,
                            device=self.device)

    def _start_partial(self, req: dict) -> None:
        """Begin chunked admission of a long prompt: resolve the cached
        prefix (if any), then run the first chunk. The request holds a
        private B=1 cache until the final chunk splices it into a slot."""
        self._note_admitted()
        self.chunked_admissions_total += 1
        prompt = req["prompt"]
        entry, plen = (None, 0)
        if self.prefix_cache is not None:
            entry, plen = self.prefix_cache.lookup(tuple(prompt))
        if entry is not None:
            req["cache_hit"] = True
            # Shared with the prefix cache: cloned lazily, only if a
            # chunk is actually written on top of it (an exact match
            # adopts without writing).
            req["_cache"] = entry.cache
            req["_shared_cache"] = True
            req["_logits"] = entry.logits
            req["_pos"] = plen
        else:
            self._reset_partial(req)
        self._partial = req
        self._advance_partial()

    def _reset_partial(self, req: dict) -> None:
        req["cache_hit"] = False
        req["_cache"] = self._fresh_partial_cache()
        req["_shared_cache"] = False
        req["_logits"] = None
        req["_pos"] = 0

    def _restart_partial(self) -> None:
        if self._partial is not None:
            self._reset_partial(self._partial)

    def _private_cache(self, req: dict) -> KVCache:
        if req.pop("_shared_cache", False):
            req["_cache"] = req["_cache"].clone()
        return req["_cache"]

    def _advance_partial(self) -> None:
        """One cycle's worth of the in-flight chunked prefill: a middle
        chunk advances the private cache; the final (<= chunk) tokens go
        through extend_slot into a free slot, or wait for one."""
        req = self._partial
        prompt = req["prompt"]
        chunk = self.prefill_chunk_tokens
        remaining = len(prompt) - req["_pos"]
        if remaining > chunk:
            tokens = self._prompt_tensor(
                prompt[req["_pos"]:req["_pos"] + chunk])
            req["_cache"], req["_logits"] = advance_cache(
                self.cfg, self.params, tokens, self._private_cache(req))
            req["_pos"] += chunk
            return
        free = next((i for i, s in enumerate(self._slots) if s is None),
                    None)
        if free is None:
            return  # chunks done; waiting for a slot to splice into
        noise = self._first_noise(req)
        if remaining == 0:
            self.state, first = adopt_slot(self.state, free, req["_cache"],
                                           req["_logits"], req["temp"],
                                           noise)
        else:
            suffix = self._prompt_tensor(prompt[req["_pos"]:])
            self.state, first, cache, logits = extend_slot(
                self.cfg, self.params, self.state, free,
                self._private_cache(req), suffix, req["temp"], noise)
            if self.prefix_cache is not None:
                self.prefix_cache.put(prompt, CacheEntry(cache, logits))
        self._partial = None
        for scratch in ("_cache", "_logits", "_pos", "_shared_cache"):
            req.pop(scratch, None)
        self._place(free, req, int(first))

    def _prefill_into(self, slot: int, req: dict) -> int:
        prompt = req["prompt"]
        noise = self._first_noise(req)
        if self.prefix_cache is None:
            self.state, first = self._prefill_plain(slot, req, noise)
            return int(first)
        entry, plen = self.prefix_cache.lookup(tuple(prompt))
        if entry is None:
            self.state, first, cache, logits = prefill_slot_keep(
                self.cfg, self.params, self.state, slot,
                self._prompt_tensor(prompt), req["temp"], noise)
            self.prefix_cache.put(prompt, CacheEntry(cache, logits))
            req["cache_hit"] = False
            return int(first)
        req["cache_hit"] = True
        if plen == len(prompt):
            self.state, first = adopt_slot(self.state, slot, entry.cache,
                                           entry.logits, req["temp"], noise)
            return int(first)
        self.state, first, cache, logits = extend_slot(
            self.cfg, self.params, self.state, slot, entry.cache.clone(),
            self._prompt_tensor(prompt[plen:]), req["temp"], noise)
        self.prefix_cache.put(prompt, CacheEntry(cache, logits))
        return int(first)

    def _prefill_plain(self, slot: int, req: dict, noise):
        return prefill_slot(self.cfg, self.params, self.state, slot,
                            self._prompt_tensor(req["prompt"]), req["temp"],
                            noise, rolling=self.rolling)

    def _finish(self, req: dict) -> None:
        # pop, not get: the engine cycles forever, so finished requests'
        # token lists must not accumulate.
        tokens = self._results.pop(req["id"], [])
        reason = ("eos" if (self.eos is not None and tokens
                            and tokens[-1] == self.eos) else "length")
        self._emit(req, {"done": True, "reason": reason,
                         "tokens": list(tokens),
                         "cache_hit": bool(req.get("cache_hit"))})

    def drain(self, max_cycles: int = 10_000) -> None:
        """Run cycles until idle (tests / batch use)."""
        for _ in range(max_cycles):
            if not self.step_cycle():
                return
        raise RuntimeError("engine did not drain")


class GenerateFallbackEngine(_EngineBase):
    """Serialized ``generate()`` engine for models the batcher refuses
    (MoE decode): one request at a time on the scheduler thread, no slots
    and no interleaving, but the same gateway-facing surface (bounded
    inbox, streamed sinks, staged swap, metered cycles). Time to first
    token degrades to the whole generation's latency: the documented cost
    of the fallback. Runs on the card unless ``device="cpu"``."""

    batched = False
    spec_ngram = False

    def __init__(self, cfg: LMConfig, params, max_len: int,
                 eos_token: int | None = None, max_pending: int = 64,
                 profiler=None, recorder=None, device=None):
        super().__init__(max_pending=max_pending, profiler=profiler,
                         recorder=recorder)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.eos = eos_token
        self.device = resolve_device(device)
        self.swaps_total = 0
        self.draining = False
        self.prefix_cache = None
        self._backlog: deque = deque()
        self.slots_total = 1  # serialized: one request "slot" at a time

    def submit_stream(self, prompt, sink: Sink, max_new_tokens: int = 128,
                      temperature: float = 0.0, rng=None) -> int:
        prompt = check_request_contract(prompt, max_new_tokens, temperature,
                                        rng)
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len {self.max_len}")
        req = {"prompt": prompt, "budget": max_new_tokens,
               "temp": float(temperature), "rng": rng, "sink": sink}
        return self._enqueue(req)

    def step_cycle(self) -> bool:
        with self.profiler.activate() as phases:
            worked = self._cycle()
        if worked:
            self._record_cycle(phases, self.pending())
        return worked

    def _cycle(self) -> bool:
        admit_started = time.monotonic()
        admitted = False
        for req in self._take_inbox():
            self._backlog.append(req)
            admitted = True
        if admitted:
            self._observe_phase("admit", time.monotonic() - admit_started)
        staged = self._staged_params()
        if staged is not None:
            # No slots to drain: between requests IS drained.
            self.params = staged
            self._consume_staged(staged)
            self.swaps_total += 1
        if not self._backlog:
            self.occupancy = 0
            return False
        req = self._backlog.popleft()
        self._note_admitted()
        self.occupancy = 1
        started = time.monotonic()
        out = generate(self.cfg, self.params, [req["prompt"]], req["budget"],
                       temperature=req["temp"], rng=req["rng"],
                       device=self.device)
        tokens = out[0].tolist()
        if self.eos is not None and self.eos in tokens:
            tokens = tokens[:tokens.index(self.eos) + 1]
        self._observe_phase("decode", time.monotonic() - started)
        for token in tokens:
            self._emit(req, {"token": token})
        reason = ("eos" if (self.eos is not None and tokens
                            and tokens[-1] == self.eos) else "length")
        self._emit(req, {"done": True, "reason": reason, "tokens": tokens,
                         "cache_hit": False})
        self.occupancy = 0
        return True

    def drain(self, max_cycles: int = 10_000) -> None:
        for _ in range(max_cycles):
            if not self.step_cycle():
                return
        raise RuntimeError("engine did not drain")


def make_engine(cfg: LMConfig, params, max_batch: int = 8,
                max_len: int = 2048, eos_token: int | None = None,
                step_chunk: int = 8, quantize_cache: bool = False,
                prefill_per_cycle: int = 2, max_pending: int = 64,
                prefix_cache_size: int = 8,
                prefill_chunk_tokens: int | None = None,
                spec_ngram: bool = False, spec_draft: int = 8,
                spec_ngram_n: int = 3, device=None):
    """The best engine the model supports, on the card unless
    ``device="cpu"``: the streaming batcher, or the serialized
    ``generate()`` fallback when the batcher refuses the config (MoE
    decode). A chunked-prefill or speculative request on a rolling
    (windowed-attention) model degrades, to monolithic prefill and
    lockstep decode, instead of refusing to serve, as in the reference: a
    tuning flag must not crash a pod that serves fine without it."""
    def build(chunk, spec):
        return StreamingBatcher(
            cfg, params, max_batch=max_batch, max_len=max_len,
            eos_token=eos_token, step_chunk=step_chunk,
            quantize_cache=quantize_cache,
            prefill_per_cycle=prefill_per_cycle, max_pending=max_pending,
            prefix_cache_size=prefix_cache_size, prefill_chunk_tokens=chunk,
            spec_ngram=spec, spec_draft=spec_draft,
            spec_ngram_n=spec_ngram_n, device=device)

    try:
        try:
            return build(prefill_chunk_tokens, spec_ngram)
        except ValueError as exc:
            if "linear slots" not in str(exc) or not (
                    prefill_chunk_tokens is not None or spec_ngram):
                raise
            log.warning("linear-slot feature unavailable (%s); serving with "
                        "monolithic prefill / lockstep decode", exc)
            return build(None, False)
    except NotImplementedError as exc:
        log.warning("continuous batching unavailable (%s); serving through "
                    "the serialized generate() fallback", exc)
        return GenerateFallbackEngine(cfg, params, max_len=max_len,
                                      eos_token=eos_token,
                                      max_pending=max_pending, device=device)


class Scheduler:
    """The scheduler thread: drives ``engine.step_cycle()`` and parks on
    the engine's wake event when idle. One per engine; the engine's
    device state is only ever touched from this thread."""

    def __init__(self, engine, idle_wait_s: float = 0.02,
                 max_consecutive_failures: int = 25):
        self.engine = engine
        self.idle_wait_s = idle_wait_s
        # Past this many back-to-back failures the scheduler is WEDGED
        # (a deterministic fault, not a poisoned request): `healthy`
        # flips false so readiness fails and the pod is restarted.
        self.max_consecutive_failures = max_consecutive_failures
        self.consecutive_failures = 0
        # Every failed cycle since start: a recovered failure still lost
        # the request it was serving.
        self.failures_total = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                worked = self.engine.step_cycle()
            except Exception:
                # A poisoned request must not take down the loop every
                # other stream depends on; park a beat, not hot-spin.
                log.exception("serving scheduler cycle failed")
                self.consecutive_failures += 1
                self.failures_total += 1
                self._stop.wait(self.idle_wait_s)
                continue
            self.consecutive_failures = 0
            if not worked:
                self.engine.wait_for_work(self.idle_wait_s)

    def start(self) -> "Scheduler":
        self._thread = threading.Thread(
            target=self._run, name="serving-scheduler", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def healthy(self) -> bool:
        """Alive AND not wedged: what readiness must gate on."""
        return (self.alive and self.consecutive_failures
                < self.max_consecutive_failures)

"""The port's bench: training and decode throughput on one card.

``python -m kubeflow_tpu_torch.bench`` runs on the card (``--device cpu``
selects the CPU) and prints ONE JSON line: the primary record, ResNet-50
training images/s, with every other section's record in
``extra_metrics``. Each record carries the perfwatch schema
(``obs/perfwatch``: per-trial values, a MAD noise band, the host-noise
grade and the provenance, which names the card, torch and CUDA), so
``python -m kubeflow_tpu_torch.obs.perfwatch verdict`` can judge it.
The line also carries ``kernel_launches``: how often each hand-written
kernel launched in this process.

Sections and metric names are the JAX package's ``bench.py``'s:

- ``resnet50_train_images_per_sec_per_chip`` (with MFU: 3 x the forward
  FLOPs an image x images/s over the card's dense bf16 peak, and
  ``vs_measured_ref``: the platform step against a plain torch step of
  the same model with hand-rolled SGD momentum, measured in the same
  process);
- ``lm_train_tokens_per_sec_per_chip`` (the 8x1024 MHA LM at batch 4 x
  2048), ``lm_long_context_tokens_per_sec_per_chip`` (S=8192),
  ``..._32k_...`` (S=32768), ``lm_sliding_window_...`` (S=8192, window
  1024), ``lm_moe_...`` and ``lm_moe_ec_...`` (8 experts every 2nd
  block, top-k and expert-choice routing);
- ``lm_decode_tokens_per_sec_per_chip`` at b1, b8, 8k and 32k prompts,
  an int8 KV cache, a rolling window cache with one-shot and chunked
  prefill, int8 weights, and self-speculative decoding (``[spec-*]``).

Modes: ``KFT_BENCH_MODE=resnet|lm|long|decode`` runs one section and
prints its record alone; the default, ``all``, runs every section, each
failing alone into a ``bench_extra_error`` record. The size knobs are
the JAX bench's (``KFT_BENCH_BATCH``, ``_STEPS``, ``_LM_SEQ``, ...), and
``KFT_BENCH_PRESET=cpu-mini`` shrinks every section to a CPU-sized
model (2 layers, dim 128) on the same code paths.

Baselines: ``vs_baseline`` is value / anchor where an anchor env var is
set (``KFT_BENCH_LM_ANCHOR``, ``KFT_BENCH_RESNET_ANCHOR``, ...) and null
otherwise. The JAX bench's built-in anchors are TPU numbers; none of
them is carried here.

Timing: every trial ends by reading a value back to the host, which
waits for the card, and ``run_timed`` times whole host-synced passes.
``KFT_BENCH_TELEMETRY=1`` also syncs and observes every step through
``obs.telemetry.StepTelemetry`` (JSONL at ``OBS_JSONL_PATH`` when set).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from kubeflow_tpu_torch import topology
from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.obs import perfwatch

_DEVICE: torch.device | None = None
_ROUND_CONTEXT: dict | None = None


def _preset() -> str:
    return os.environ.get("KFT_BENCH_PRESET", "")


def _mini(full: int, mini: int) -> int:
    """A section size, or its CPU-sized twin under
    ``KFT_BENCH_PRESET=cpu-mini`` (the preset rides in provenance)."""
    return mini if _preset() == "cpu-mini" else full


def _lm_dims(**overrides) -> dict:
    """The LM's dims: the 8x1024 bench config, or 2x128 under cpu-mini."""
    dims = (dict(vocab=2048, layers=2, dim=128, heads=4)
            if _preset() == "cpu-mini"
            else dict(vocab=32768, layers=8, dim=1024, heads=8))
    dims.update(overrides)
    return dims


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _env_anchor(name: str) -> float | None:
    """An anchor from the environment (value / anchor is the record's
    ``vs_baseline``); unset or 0 means none."""
    return float(os.environ.get(name, "0") or 0) or None


def _vs(value: float, anchor: float | None) -> float | None:
    return round(value / anchor, 4) if anchor else None


def device() -> torch.device:
    return _DEVICE if _DEVICE is not None else resolve_device()


def round_context() -> dict:
    """The host-noise sentinel and provenance, measured once per bench
    process and stamped into every section's record."""
    global _ROUND_CONTEXT
    if _ROUND_CONTEXT is None:
        _ROUND_CONTEXT = {"noise": perfwatch.host_noise_sentinel(),
                          "provenance": perfwatch.provenance(
                              device=device())}
    return _ROUND_CONTEXT


def _protocol_fields(rate: perfwatch.Measurement) -> dict:
    """The perfwatch fields every section's record carries."""
    ctx = round_context()
    return {"schema": perfwatch.SCHEMA, **rate.to_dict(ndigits=1),
            "noise": ctx["noise"], "provenance": ctx["provenance"]}


def _section_key(metric_name: str) -> str:
    """"lm_decode_tokens_per_sec_per_chip[b1]" -> "decode[b1]": the
    anchor-registry and ledger key, as the JAX bench's."""
    return (metric_name.replace("lm_", "", 1)
            .replace("_tokens_per_sec_per_chip", ""))


def device_name() -> str:
    return topology.device_name(device())


def make_step_telemetry(flops_per_example: float):
    """``KFT_BENCH_TELEMETRY=1``: a StepTelemetry that observes every
    timed step (per-step syncs perturb the headline, so it is off by
    default)."""
    if os.environ.get("KFT_BENCH_TELEMETRY", "").lower() not in (
            "1", "true", "yes"):
        return None
    from kubeflow_tpu_torch.obs.telemetry import StepTelemetry

    return StepTelemetry(flops_per_example=flops_per_example,
                         device_kind=device_name())


def run_timed(step, state, batch, warmup: int, steps: int, telemetry=None,
              trials: int | None = None):
    """Time ``trials`` passes of ``steps`` steps after ``warmup`` steps,
    each pass ended by reading the loss (which waits for the card).
    Returns ``(state, Measurement)`` of seconds per pass.

    With ``telemetry`` each step is synced and observed under a profiler
    activation split into ``dispatch`` and ``sync``; a pass's time is
    then the sum of its steps', and the measurement's ``phases`` carry
    the two digests."""
    if steps <= 0:
        raise SystemExit("KFT_BENCH_STEPS must be >= 1")
    trials = max(1, _env_int("KFT_BENCH_TIMING_REPS", 3)
                 if trials is None else int(trials))
    metrics = None
    for _ in range(warmup):
        state, metrics = step(state, batch)
    if metrics is not None:
        float(metrics["loss"])
    trial_secs, losses = [], []
    if telemetry is not None:
        from kubeflow_tpu_torch.obs.profile import PhaseProfiler

        profiler = PhaseProfiler(memory=False)
        batch_size = len(next(iter(batch.values())))
        index = 0
        for _trial in range(trials):
            total = 0.0
            for _ in range(steps):
                with profiler.activate():
                    t0 = time.perf_counter()
                    with profiler.phase("dispatch"):
                        state, metrics = step(state, batch)
                    with profiler.phase("sync"):
                        losses.append(float(metrics["loss"]))
                    seconds = time.perf_counter() - t0
                    total += seconds
                    telemetry.observe(batch_size, seconds, step=index)
                    index += 1
            trial_secs.append(total)
        measurement = perfwatch.Measurement.from_values(trial_secs)
        measurement.phases = profiler.compact()
    else:
        for _trial in range(trials):
            t0 = time.perf_counter()
            for _ in range(steps):
                state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            trial_secs.append(time.perf_counter() - t0)
        measurement = perfwatch.Measurement.from_values(trial_secs)
    if not all(math.isfinite(x) for x in losses):
        raise FloatingPointError(f"non-finite losses {losses}")
    return state, measurement


def _tokens(rng, vocab: int, shape) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, vocab, size=shape)).to(device())


def bench_lm(seq: int, batch: int, steps: int, warmup: int, metric: str,
             anchor: float | None, window: int | None = None,
             moe_experts: int = 0, moe_router: str = "topk") -> dict:
    """LM training tokens/s through the flash kernels' forward and
    backward (``make_lm_train_step``), f32 parameters from seed 0, bf16
    compute; ``window`` is a sliding window, ``moe_experts`` an MoE
    layer in every 2nd block. MFU: tokens/s x
    ``train_flops_per_sequence`` / seq over the card's peak."""
    from kubeflow_tpu_torch.models import (
        LMConfig,
        build_lm,
        create_lm_state,
        make_lm_train_step,
    )
    from kubeflow_tpu_torch.models.transformer import (
        train_flops_per_sequence,
    )

    cfg = LMConfig(**_lm_dims(), dtype=torch.bfloat16, attn_window=window,
                   moe_experts=moe_experts,
                   **({"moe_every": 2, "moe_router": moe_router}
                      if moe_experts else {}))
    state = create_lm_state(build_lm(cfg), seed=0, device=device())
    tokens = _tokens(np.random.default_rng(0), cfg.vocab, (batch, seq))
    flops = train_flops_per_sequence(cfg, seq)
    state, meas = run_timed(make_lm_train_step(cfg=cfg), state,
                            {"tokens": tokens}, warmup, steps,
                            telemetry=make_step_telemetry(flops))
    rate = meas.as_rate(batch * seq * steps)
    peak = topology.peak_flops_for_device_name(device_name())
    return {
        "metric": metric,
        "value": round(rate.median, 1),
        "unit": "tokens/sec/chip",
        "vs_baseline": _vs(rate.median, anchor),
        "seq": seq,
        "batch": batch,
        **({"window": window} if window is not None else {}),
        **({"moe_experts": moe_experts, "moe_router": moe_router}
           if moe_experts else {}),
        "step_ms": round(1000 * meas.median / steps, 2),
        "mfu": round(rate.median / seq * flops / peak, 4),
        **_protocol_fields(rate),
        "device": device_name(),
    }


def _decode_cfg(window: int | None = None):
    from kubeflow_tpu_torch.models import LMConfig

    return LMConfig(**_lm_dims(), kv_heads=2, dtype=torch.bfloat16,
                    attn_window=window)


def _decode_params(cfg):
    """Seed-0 weights in the compute dtype, as the serving path holds
    them."""
    from kubeflow_tpu_torch.models import init_params

    return init_params(cfg, seed=0, device=device(), dtype=cfg.dtype)


def bench_decode(batch: int, prompt_len: int, new_tokens: int,
                 prefill_anchor: float | None, decode_anchor: float | None,
                 window: int | None = None, quantized: bool = False,
                 weight_int8: bool = False,
                 prefill_chunk: int | None = None) -> dict:
    """KV-cache inference (``models/decoding``) on the 8x1024 GQA config
    (2 kv heads): prefill tokens/s over ``KFT_BENCH_PREFILL_REPS`` prompts
    a pass, and greedy decode tokens/s over ``new_tokens`` single-token
    steps from the prefilled cache (cloned each pass). ``window`` decodes
    from the rolling cache (``prefill_chunk``: prefilled in chunks),
    ``quantized`` an int8 cache, ``weight_int8`` int8 weights. The
    weights are the unrolled per-layer dict with q|k|v concatenated once
    for the fused kernel, as the batcher holds them;
    ``KFT_BENCH_DECODE_PATH=stacked`` decodes from stacked params."""
    from kubeflow_tpu_torch.models import (
        KVCache,
        forward_with_cache,
        quantize_decode_params,
        stack_decode_params,
    )
    from kubeflow_tpu_torch.models.decoding import fuse_qkv_params

    cfg = _decode_cfg(window)
    rolling = window is not None
    rng = np.random.default_rng(0)
    prompt = _tokens(rng, cfg.vocab, (batch, prompt_len))
    params = _decode_params(cfg)
    if weight_int8:
        params = quantize_decode_params(cfg, params)
    decode_path = os.environ.get("KFT_BENCH_DECODE_PATH", "unrolled")
    if decode_path == "stacked":
        if weight_int8:
            raise SystemExit("KFT_BENCH_DECODE_PATH=stacked does not compose "
                             "with weight_int8 (int8 decode runs the "
                             "unrolled path)")
        params = stack_decode_params(cfg, params)
    else:
        # As the batcher does: q|k|v concatenated once for the fused
        # QKV+RoPE kernel, not at every step.
        params = fuse_qkv_params(cfg, params, rows=batch)
    if prefill_chunk is not None and (not rolling
                                      or prompt_len % prefill_chunk):
        raise SystemExit("prefill_chunk benches the chunked rolling path "
                         "and must divide the prompt")
    max_len = prompt_len + new_tokens
    prefill_reps = _env_int("KFT_BENCH_PREFILL_REPS", _mini(8, 2))
    reps = _env_int("KFT_BENCH_TIMING_REPS", 3)

    def prefill(prompt):
        cache = KVCache.init(cfg, batch, max_len, rolling=rolling,
                             quantized=quantized, device=device())
        chunk = prefill_chunk or prompt_len
        for start in range(0, prompt_len, chunk):
            logits, cache = forward_with_cache(
                cfg, params, prompt[:, start:start + chunk], cache,
                last_logits_only=True, device=device())
        return logits[:, -1].argmax(-1), cache

    prompts = _tokens(rng, cfg.vocab, (prefill_reps, batch, prompt_len))

    def prefill_pass():
        acc = torch.zeros((), dtype=torch.long, device=device())
        for prompt_i in prompts:
            acc = acc ^ prefill(prompt_i)[0][0]
        int(acc)

    first, cache = prefill(prompt)
    int(first[0])
    prefill_pass()
    prefill_rate = perfwatch.timed_trials(prefill_pass, trials=reps).as_rate(
        prefill_reps * batch * prompt_len)

    def decode_pass():
        token, c = first, cache.clone()
        for _ in range(new_tokens):
            logits, c = forward_with_cache(cfg, params, token[:, None], c,
                                           device=device())
            token = logits[:, -1].argmax(-1)
        int(token[0])

    decode_pass()
    decode_meas = perfwatch.timed_trials(decode_pass, trials=reps)
    decode_rate = decode_meas.as_rate(batch * new_tokens)
    return {
        "metric": "lm_decode_tokens_per_sec_per_chip",
        "value": round(decode_rate.median, 1),
        "unit": "tokens/sec/chip",
        "vs_baseline": _vs(decode_rate.median, decode_anchor),
        "batch": batch,
        "prompt_len": prompt_len,
        "new_tokens": new_tokens,
        **({"window": window, "rolling_cache": True}
           if window is not None else {}),
        **({"prefill_chunk": prefill_chunk} if prefill_chunk else {}),
        **({"kv_cache": "int8"} if quantized else {}),
        **({"weights": "int8"} if weight_int8 else {}),
        **({"decode_path": decode_path} if decode_path != "unrolled"
           else {}),
        "decode_step_ms": round(1000 * decode_meas.median / new_tokens, 3),
        "prefill_tokens_per_sec": round(prefill_rate.median, 1),
        "prefill_vs_baseline": _vs(prefill_rate.median, prefill_anchor),
        "prefill_band": prefill_rate.band,
        **_protocol_fields(decode_rate),
        "device": device_name(),
    }


def bench_decode_spec(prompt_len: int, new_tokens: int,
                      decode_anchor: float | None, draft: int = 8,
                      ngram: int = 3, repeat_period: int = 64) -> dict:
    """Self-speculative n-gram decoding (``models/speculative``) at batch
    1 on a ``repeat_period``-token random segment tiled to
    ``prompt_len``; the record carries the accept rate that the tiled
    prompt's structure bought."""
    from kubeflow_tpu_torch.models import speculative_generate

    cfg = _decode_cfg()
    rng = np.random.default_rng(0)
    base = rng.integers(0, cfg.vocab, size=repeat_period)
    tiled = np.tile(base, -(-prompt_len // repeat_period))[:prompt_len]
    prompt = torch.from_numpy(tiled[None, :]).to(device())
    params = _decode_params(cfg)

    def spec():
        return speculative_generate(cfg, params, prompt, new_tokens,
                                    draft=draft, ngram=ngram,
                                    return_stats=True, device=device())

    out, stats = spec()
    int(out[0, -1])

    def spec_pass():
        out, _ = spec()
        int(out[0, -1])

    meas = perfwatch.timed_trials(
        spec_pass, trials=_env_int("KFT_BENCH_TIMING_REPS", 3))
    rate = meas.as_rate(new_tokens)
    return {
        "metric": "lm_decode_tokens_per_sec_per_chip",
        "value": round(rate.median, 1),
        "unit": "tokens/sec/chip",
        "vs_baseline": _vs(rate.median, decode_anchor),
        "batch": 1,
        "prompt_len": prompt_len,
        "new_tokens": new_tokens,
        "speculative": {"draft": draft, "ngram": ngram,
                        "repeat_period": repeat_period},
        "accept_rate": round(stats.accept_rate, 4),
        "tokens_per_verify": round(stats.tokens_per_verify, 2),
        "verify_calls": int(stats.verify_calls),
        "decode_step_ms": round(1000 * meas.median / new_tokens, 3),
        **_protocol_fields(rate),
        "device": device_name(),
    }


def _image_batch(batch: int, image_size: int) -> dict:
    rng = np.random.default_rng(0)
    images = rng.normal(size=(batch, image_size, image_size, 3))
    return {"image": torch.from_numpy(images).to(device(), torch.bfloat16),
            "label": torch.from_numpy(rng.integers(0, 1000, size=(batch,)))
            .to(device())}


def _measure_plain_reference(image_size: int, batch: int, steps: int,
                             warmup: int) -> float:
    """The plain reference, measured in this process: the same ResNet-50
    on its raw parameters, an f32 log-softmax loss and hand-rolled SGD
    with momentum 0.9 over the parameter dict, no platform code (no
    TrainState, optimizer module, label smoothing or metrics). Returns
    images/s."""
    from kubeflow_tpu_torch.models import resnet50
    from kubeflow_tpu_torch.models.optim import flatten

    model = resnet50(num_classes=1000)
    variables = model.init_variables(0, device=device())
    leaves = [t.requires_grad_() for _, t in flatten(variables["params"])]
    momentum = [torch.zeros_like(t) for t in leaves]
    carry = {"stats": variables["batch_stats"]}

    def step(params, batch):
        logits, carry["stats"] = model(params, carry["stats"],
                                       batch["image"], train=True)
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -logp.gather(1, batch["label"][:, None]).mean()
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, m, g in zip(leaves, momentum, grads):
                m.mul_(0.9).add_(g)
                p.sub_(0.1 * m)
        return params, {"loss": loss.detach()}

    _, meas = run_timed(step, variables["params"],
                        _image_batch(batch, image_size), warmup, steps)
    return batch * steps / meas.median


def bench_resnet() -> dict:
    """ResNet-50 training images/s: ``make_train_step`` (label smoothing
    0.1, ``make_optimizer``'s Nesterov SGD) on bf16 images from seed 0,
    1000 classes."""
    from kubeflow_tpu_torch.models import (
        create_train_state,
        make_train_step,
        resnet50,
    )
    from kubeflow_tpu_torch.models.resnet import resnet_flops_per_image

    batch = _env_int("KFT_BENCH_BATCH", _mini(256, 8))
    image_size = _env_int("KFT_BENCH_IMAGE_SIZE", _mini(224, 32))
    steps = _env_int("KFT_BENCH_STEPS", _mini(20, 3))
    warmup = _env_int("KFT_BENCH_WARMUP", _mini(8, 1))
    state = create_train_state(resnet50(num_classes=1000), 0,
                               (2, image_size, image_size, 3),
                               device=device())
    flops = 3.0 * resnet_flops_per_image("resnet50", image_size)
    telemetry = make_step_telemetry(flops)
    state, meas = run_timed(make_train_step(smoothing=0.1), state,
                            _image_batch(batch, image_size), warmup, steps,
                            telemetry=telemetry)
    del state
    rate = meas.as_rate(batch * steps)
    peak = topology.peak_flops_for_device_name(device_name())
    record = {
        "metric": "resnet50_train_images_per_sec_per_chip",
        "section": "resnet",
        "value": round(rate.median, 2),
        "unit": "images/sec/chip",
        "vs_baseline": _vs(rate.median, _env_anchor(
            "KFT_BENCH_RESNET_ANCHOR")),
        "mfu": round(rate.median * flops / peak, 4),
        "batch": batch,
        "steps": steps,
        "step_ms": round(1000 * meas.median / steps, 2),
        **_protocol_fields(rate),
        "device": device_name(),
    }
    if telemetry is not None:
        record["step_telemetry"] = telemetry.summary()
    if os.environ.get("KFT_BENCH_SKIP_MEASURED_REF", "") not in ("1", "true"):
        ref = _measure_plain_reference(image_size, batch, steps, warmup)
        record["measured_ref_img_s"] = round(ref, 2)
        record["vs_measured_ref"] = round(rate.median / (0.9 * ref), 4)
    return record


def _sections(lm_defaults: dict) -> list:
    """(metric name, mandatory, thunk) of every section after ResNet, in
    the JAX bench's order."""
    long_seq = _env_int("KFT_BENCH_LONG_SEQ", _mini(8192, 256))
    long_steps = _env_int("KFT_BENCH_LONG_STEPS", _mini(5, 2))
    long_warmup = _env_int("KFT_BENCH_LONG_WARMUP", _mini(2, 1))
    long_batch = _env_int("KFT_BENCH_LONG_BATCH", 1)
    new_tokens = _env_int("KFT_BENCH_NEW_TOKENS", _mini(256, 32))
    prompt = _env_int("KFT_BENCH_PROMPT", _mini(1024, 128))
    p8k, p32k = _mini(8192, 256), _mini(32768, 512)
    a = _env_anchor

    def lm(metric, **kw):
        return lambda: bench_lm(metric=metric, **kw)

    def decode(**kw):
        return lambda: bench_decode(**kw)

    name = "lm_decode_tokens_per_sec_per_chip"
    return [
        ("lm_train_tokens_per_sec_per_chip", True,
         lm("lm_train_tokens_per_sec_per_chip",
            anchor=a("KFT_BENCH_LM_ANCHOR"), **lm_defaults)),
        ("lm_long_context_tokens_per_sec_per_chip", False,
         lm("lm_long_context_tokens_per_sec_per_chip",
            anchor=a("KFT_BENCH_LONG_ANCHOR"), batch=long_batch,
            seq=long_seq, steps=long_steps, warmup=long_warmup)),
        ("lm_long_context_32k_tokens_per_sec_per_chip", False,
         lm("lm_long_context_32k_tokens_per_sec_per_chip",
            anchor=a("KFT_BENCH_LONG32K_ANCHOR"), batch=1,
            seq=_env_int("KFT_BENCH_LONG32K_SEQ", p32k),
            steps=_env_int("KFT_BENCH_LONG32K_STEPS", _mini(3, 2)),
            warmup=_env_int("KFT_BENCH_LONG32K_WARMUP", 1))),
        ("lm_sliding_window_tokens_per_sec_per_chip", False,
         lm("lm_sliding_window_tokens_per_sec_per_chip",
            anchor=a("KFT_BENCH_WINDOW_ANCHOR"), batch=long_batch,
            seq=long_seq, steps=long_steps, warmup=long_warmup,
            window=_env_int("KFT_BENCH_WINDOW", _mini(1024, 64)))),
        (f"{name}[b1]", False, decode(
            batch=1, prompt_len=prompt, new_tokens=new_tokens,
            prefill_anchor=a("KFT_BENCH_PREFILL_ANCHOR"),
            decode_anchor=a("KFT_BENCH_DECODE_ANCHOR"))),
        (f"{name}[b8]", False, decode(
            batch=8, prompt_len=prompt, new_tokens=new_tokens,
            prefill_anchor=a("KFT_BENCH_PREFILL_B8_ANCHOR"),
            decode_anchor=a("KFT_BENCH_DECODE_B8_ANCHOR"))),
        ("lm_moe_tokens_per_sec_per_chip", False,
         lm("lm_moe_tokens_per_sec_per_chip",
            anchor=a("KFT_BENCH_MOE_ANCHOR"), moe_experts=8,
            **lm_defaults)),
        ("lm_moe_ec_tokens_per_sec_per_chip", False,
         lm("lm_moe_ec_tokens_per_sec_per_chip",
            anchor=a("KFT_BENCH_MOE_EC_ANCHOR"), moe_experts=8,
            moe_router="expert_choice", **lm_defaults)),
        (f"{name}[b1-p8k]", False, decode(
            batch=1, prompt_len=p8k, new_tokens=_mini(128, 32),
            prefill_anchor=a("KFT_BENCH_PREFILL_P8K_ANCHOR"),
            decode_anchor=a("KFT_BENCH_DECODE_P8K_ANCHOR"))),
        (f"{name}[b1-p32k]", False, decode(
            batch=1, prompt_len=p32k, new_tokens=_mini(64, 16),
            prefill_anchor=a("KFT_BENCH_PREFILL_P32K_ANCHOR"),
            decode_anchor=a("KFT_BENCH_DECODE_P32K_ANCHOR"))),
        (f"{name}[b8-p8k]", False, decode(
            batch=8, prompt_len=p8k, new_tokens=_mini(64, 16),
            prefill_anchor=a("KFT_BENCH_PREFILL_B8P8K_ANCHOR"),
            decode_anchor=a("KFT_BENCH_DECODE_B8P8K_ANCHOR"))),
        (f"{name}[b8-p8k-int8]", False, decode(
            batch=8, prompt_len=p8k, new_tokens=_mini(64, 16),
            quantized=True,
            prefill_anchor=a("KFT_BENCH_PREFILL_B8P8K_INT8_ANCHOR"),
            decode_anchor=a("KFT_BENCH_DECODE_B8P8K_INT8_ANCHOR"))),
        (f"{name}[b1-p8k-w1k]", False, decode(
            batch=1, prompt_len=p8k, new_tokens=_mini(128, 32),
            window=_mini(1024, 64),
            prefill_anchor=a("KFT_BENCH_PREFILL_W1K_ANCHOR"),
            decode_anchor=a("KFT_BENCH_DECODE_W1K_ANCHOR"))),
        (f"{name}[b1-p32k-w1k]", False, decode(
            batch=1, prompt_len=p32k, new_tokens=_mini(128, 32),
            window=_mini(1024, 64), prefill_chunk=_mini(2048, 128),
            prefill_anchor=a("KFT_BENCH_PREFILL_P32KW1K_ANCHOR"),
            decode_anchor=a("KFT_BENCH_DECODE_P32KW1K_ANCHOR"))),
        (f"{name}[b1-w8]", False, decode(
            batch=1, prompt_len=prompt, new_tokens=new_tokens,
            weight_int8=True, prefill_anchor=None,
            decode_anchor=a("KFT_BENCH_DECODE_B1W8_ANCHOR"))),
        (f"{name}[b1-p8k-w8]", False, decode(
            batch=1, prompt_len=p8k, new_tokens=_mini(128, 32),
            weight_int8=True, prefill_anchor=None,
            decode_anchor=a("KFT_BENCH_DECODE_P8KW8_ANCHOR"))),
        (f"{name}[spec-b1]", False, lambda: bench_decode_spec(
            prompt_len=prompt, new_tokens=new_tokens,
            decode_anchor=a("KFT_BENCH_DECODE_ANCHOR"))),
        (f"{name}[spec-b1-p8k]", False, lambda: bench_decode_spec(
            prompt_len=p8k, new_tokens=_mini(128, 32),
            decode_anchor=a("KFT_BENCH_DECODE_P8K_ANCHOR"))),
    ]


def _free() -> None:
    """Hand a finished section's memory back before the next one."""
    if device().type == "cuda":
        torch.cuda.synchronize(device())
        torch.cuda.empty_cache()


def _launches() -> dict:
    from kubeflow_tpu_torch.ops import _build

    return dict(_build.LAUNCHES)


def run(mode: str = "all") -> tuple[dict, int]:
    """One bench run in ``mode``: (the record to print, exit code). The
    combined run's exit code is 3 when a mandatory section failed."""
    from kubeflow_tpu_torch.ops import _build

    _build.reset_launches()
    single = "" if mode == "lm" else "LM_"
    lm_defaults = dict(
        batch=_env_int(f"KFT_BENCH_{single}BATCH", _mini(4, 2)),
        seq=_env_int(f"KFT_BENCH_{single}SEQ", _mini(2048, 128)),
        steps=_env_int(f"KFT_BENCH_{single}STEPS", _mini(10, 3)),
        warmup=_env_int(f"KFT_BENCH_{single}WARMUP", _mini(4, 1)))
    if mode == "lm":
        record = bench_lm(metric="lm_train_tokens_per_sec_per_chip",
                          anchor=_env_anchor("KFT_BENCH_LM_ANCHOR"),
                          **lm_defaults)
        record.setdefault("section", "train")
    elif mode == "long":
        record = bench_lm(
            metric="lm_long_context_tokens_per_sec_per_chip",
            anchor=_env_anchor("KFT_BENCH_LONG_ANCHOR"),
            batch=_env_int("KFT_BENCH_BATCH", 1),
            seq=_env_int("KFT_BENCH_SEQ", _mini(8192, 256)),
            steps=_env_int("KFT_BENCH_STEPS", _mini(5, 2)),
            warmup=_env_int("KFT_BENCH_WARMUP", _mini(2, 1)),
            window=_env_int("KFT_BENCH_WINDOW", 0) or None)
        record.setdefault("section", "long_context")
    elif mode == "decode":
        batch = _env_int("KFT_BENCH_BATCH", 1)
        record = bench_decode(
            batch=batch,
            prompt_len=_env_int("KFT_BENCH_PROMPT", _mini(1024, 128)),
            new_tokens=_env_int("KFT_BENCH_NEW_TOKENS", _mini(256, 32)),
            prefill_anchor=_env_anchor("KFT_BENCH_PREFILL_ANCHOR"),
            decode_anchor=_env_anchor("KFT_BENCH_DECODE_ANCHOR"))
        record.setdefault("section", f"decode[b{batch}]")
    elif mode == "resnet":
        record = bench_resnet()
    elif mode == "all":
        return _run_all(lm_defaults)
    else:
        raise SystemExit(f"unknown KFT_BENCH_MODE {mode!r}")
    record["kernel_launches"] = _launches()
    return record, 0


def _run_all(lm_defaults: dict) -> tuple[dict, int]:
    """The combined record: ResNet primary, every other section in
    ``extra_metrics``, each failing alone into a ``bench_extra_error``
    record that names it (``KFT_BENCH_RETRIES``, default 1, and
    ``KFT_BENCH_RETRIES_MANDATORY`` for the LM section)."""
    record = bench_resnet()
    _free()
    sections = _sections(lm_defaults)
    extras = []
    for name, mandatory, section in sections:
        attempts = max(1, _env_int("KFT_BENCH_RETRIES_MANDATORY" if mandatory
                                   else "KFT_BENCH_RETRIES", 1))
        error = None
        for attempt in range(attempts):
            try:
                result = section()
                result.setdefault("section", _section_key(name))
                extras.append(result)
                error = None
                break
            # analysis: allow[py-broad-except] — bench harness: a failing section is recorded by name, the rest still run
            except Exception as exc:
                error = exc
                if attempt + 1 < attempts:
                    time.sleep(min(10.0, 2.0 * (attempt + 1)))
            finally:
                _free()
        if error is not None:
            extras.append({"metric": "bench_extra_error", "section": name,
                           "attempts": attempts,
                           "error": f"{type(error).__name__}: {error}"})
    record["extra_metrics"] = extras
    record["kernel_launches"] = _launches()
    failed = {e["section"] for e in extras
              if e.get("metric") == "bench_extra_error"}
    mandatory = {name for name, must, _ in sections if must}
    return record, 3 if failed & mandatory else 0


def main(argv: list[str] | None = None) -> int:
    global _DEVICE
    parser = argparse.ArgumentParser(
        prog="python -m kubeflow_tpu_torch.bench",
        description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the card)")
    args = parser.parse_args(argv)
    _DEVICE = resolve_device(args.device)
    record, code = run(os.environ.get("KFT_BENCH_MODE", "all"))
    full_path = os.environ.get("KFT_BENCH_FULL_PATH")
    if full_path:
        with open(full_path, "w") as fh:
            json.dump(record, fh, indent=1)
            fh.write("\n")
    print(json.dumps(record), flush=True)
    return code


if __name__ == "__main__":
    raise SystemExit(main())

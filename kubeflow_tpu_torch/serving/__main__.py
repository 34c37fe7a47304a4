"""Inference-gateway pod entrypoint: ``python -m kubeflow_tpu_torch.serving``.

The counterpart of ``kubeflow_tpu/serving/__main__.py``, with the same
env contract (the ``inference-env`` PodDefault injects the KFT_SERVING_*
variables; ``KFT_SERVING_CONFIG`` comes from the image or the CR
template):

- ``KFT_SERVING_CONFIG`` — JSON object of LMConfig overrides
  (vocab/layers/dim/heads/kv_heads/dtype/...; ``dtype`` by torch name,
  e.g. ``"bfloat16"``, the kernels' dtype); defaults to a small dev
  model. The weights are a random init (``init_params``, seed 0, in the
  config's dtype): not the reference's ``jax.random.key(0)`` numbers.
- ``KFT_SERVING_MODEL_DIR`` — checkpoint directory served from; the
  newest valid step loads at boot (``restore_latest_valid`` into
  ``build_model``'s params, each leaf cast to their dtype, so an f32
  training checkpoint serves in the config's dtype) and again on every
  ``POST /v1/admin/swap`` (hot swap). With no valid step the pod warns
  and serves the initialised params; the swap then answers 409.
- ``KFT_SERVING_MAX_BATCH`` / ``KFT_SERVING_MAX_LEN`` — decode slots /
  slot capacity. ``KFT_SERVING_EOS`` — optional eos token id.
  ``KFT_SERVING_PORT`` — HTTP port (default 8800).
- ``KFT_SERVING_PREFILL_CHUNK`` — chunked-prefill admission threshold
  (unset = monolithic prefill).
- ``KFT_SERVING_SPEC_NGRAM`` — "1"/"true" enables self-speculative
  n-gram decoding (linear slots only; a rolling model warns and serves
  lockstep). ``KFT_SERVING_SPEC_DRAFT`` (default 8) drafted tokens per
  verify, ``KFT_SERVING_SPEC_NGRAM_N`` (default 3) the longest n-gram
  context.
- An MoE config (``moe_experts`` > 0) starts on the serialized
  ``generate()`` fallback engine (the batcher refuses MoE decode).
- ``KFT_AUTOPILOT`` — "0" disables the SLO autopilot (default on: the
  gateway admission actuator tightens max_pending / prefill_per_cycle
  while TTFT/ITL burn is critical and restores them on resolve).
  ``KFT_AUTOPILOT_SHED_FACTOR`` (default 4) sets how hard admission
  tightens; ``KFT_AUTOPILOT_MIN_INTERVAL_S`` (default 60) rate-limits
  actuations.

The pod runs on the card; ``main(device="cpu")`` is for tests. SIGTERM
or SIGINT stops the gateway and the scheduler, logs the kernel launches
made while serving (the record's ``kernel_launches``, counted from the
gateway's start; a CPU twin is no launch), and ``main`` returns.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time

# Named, not ``__name__``: run with ``python -m`` this module is
# "__main__", outside the port's logger tree that
# configure_structured_logging sets up, and its records would be lost.
log = logging.getLogger("kubeflow_tpu_torch.serving.__main__")


def build_model(env: dict, device=None):
    """(cfg, params) from the env: config overrides + a seeded random
    init on the card (or ``device``)."""
    import torch

    from kubeflow_tpu_torch._device import resolve_device
    from kubeflow_tpu_torch.models.transformer import LMConfig, init_params

    overrides = json.loads(env.get("KFT_SERVING_CONFIG") or "{}")
    if "dtype" in overrides:
        dtype = getattr(torch, str(overrides["dtype"]), None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"KFT_SERVING_CONFIG dtype "
                             f"{overrides['dtype']!r} is not a torch dtype")
        overrides["dtype"] = dtype
    cfg = LMConfig(**overrides)
    params = init_params(cfg, seed=0, device=resolve_device(device),
                         dtype=cfg.dtype)
    return cfg, params


def make_reload_fn(model_dir: str, template):
    """The hot-swap hook: load the newest digest-valid checkpoint into
    the template's shape and dtypes; (None, info) when nothing valid
    exists (the gateway answers 409 and serving continues on the current
    params)."""

    def reload_fn():
        from kubeflow_tpu_torch.models.checkpoint import (
            CheckpointManager,
            _world_identity,
        )

        # The live world's identity: in a multi-process deployment every
        # rank restores the step process 0 validated and broadcast. A
        # single process starts no process group.
        manager = CheckpointManager(model_dir, **_world_identity())
        result = manager.restore_latest_valid({"params": template})
        if result is None:
            return None, {"dir": model_dir, "step": None}
        state, step = result
        return state["params"], {"dir": model_dir, "step": step}

    return reload_fn


def main(argv=None, device=None) -> None:
    from kubeflow_tpu_torch.autopilot import (
        Autopilot,
        GatewayAdmissionActuator,
        autopilot_enabled,
    )
    from kubeflow_tpu_torch.obs import configure_structured_logging
    from kubeflow_tpu_torch.obs.envknob import env_number
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.serving.engine import make_engine
    from kubeflow_tpu_torch.serving.gateway import InferenceGateway

    configure_structured_logging()
    env = dict(os.environ)
    cfg, params = build_model(env, device=device)
    model_dir = env.get("KFT_SERVING_MODEL_DIR", "")
    reload_fn = None
    if model_dir:
        reload_fn = make_reload_fn(model_dir, params)
        t0 = time.perf_counter()
        loaded, info = reload_fn()
        if loaded is not None:
            params = loaded
            log.info("serving checkpoint step %s from %s", info["step"],
                     model_dir, extra={
                         "restore_s": time.perf_counter() - t0})
        else:
            log.warning("no valid checkpoint under %s; serving "
                        "initialised params", model_dir)
    eos = env.get("KFT_SERVING_EOS")
    chunk = env.get("KFT_SERVING_PREFILL_CHUNK")
    spec = env.get("KFT_SERVING_SPEC_NGRAM", "").lower() in (
        "1", "true", "yes")
    engine = make_engine(
        cfg, params,
        max_batch=int(env.get("KFT_SERVING_MAX_BATCH", "8")),
        max_len=int(env.get("KFT_SERVING_MAX_LEN", "2048")),
        eos_token=int(eos) if eos else None,
        prefill_chunk_tokens=int(chunk) if chunk else None,
        spec_ngram=spec,
        spec_draft=int(env.get("KFT_SERVING_SPEC_DRAFT", "8")),
        spec_ngram_n=int(env.get("KFT_SERVING_SPEC_NGRAM_N", "3")),
        device=device,
    )
    autopilot = None
    if autopilot_enabled():
        autopilot = Autopilot(recorder=engine.recorder)
        autopilot.register(GatewayAdmissionActuator(
            engine,
            shed_factor=env_number("KFT_AUTOPILOT_SHED_FACTOR", 4,
                                   cast=int, minimum=2),
        ))
    _build.reset_launches()
    gateway = InferenceGateway(
        engine,
        port=int(env.get("KFT_SERVING_PORT", "8800")),
        reload_fn=reload_fn,
        autopilot=autopilot,
    ).start()
    log.info("inference gateway serving on :%d (batched=%s, device=%s)",
             gateway.port, engine.batched, engine.device)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    gateway.stop()
    log.info("kernel launches while serving",
             extra={"kernel_launches": dict(_build.LAUNCHES)})


if __name__ == "__main__":
    main()

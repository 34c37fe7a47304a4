#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one H100,
kernels included.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card of compute capability 9.0 and ``nvcc``; the kernels in
``kubeflow_tpu_torch/csrc/`` build at first use into
``kubeflow_tpu_torch/build/``. It imports nothing of JAX.

Phases (a failed phase raises; nothing is caught):

1. kernels: each hand-written kernel against its plain PyTorch twin on
   the card, at the flagship's own shapes (8 layers, dim 1024, 8 heads,
   2 kv heads, vocab 32768, bf16), decode attention and the fused
   QKV+RoPE also at the train config's MHA shapes (8 kv heads), and,
   for the flash forward with lse and the two backward kernels, at the
   training shape (batch 4, 8 heads,
   S=2048, head dim 128), four more masks and the long phase's shape
   (batch 1, 8 heads, S=8192; SDPA's forward and backward as the library
   calls), the flash forward also at the spec-p8k prefill (batch 1, 8
   heads, 2 kv heads, S=8192, no lse), element by element within the
   stated tolerance
   (see ``check_close``); the GEMV's int8 cases launch as the model
   does (scale in the kernel with a residual, after it without); two
   launches of the GEMV must give equal bits (tied head in bf16 and
   int8, down projection), and so must two launches of the fused
   QKV+RoPE and of decode attention, and each of their rows launched
   alone (a batch of one) must equal its row of the batch; kernel, twin and
   library-call times (CUDA events, median of repeated launches, L2
   flushed before each) beside the least time the card could take (bytes
   over 3.35 TB/s or operations over the card's dense bf16 peak, 989
   TFLOP/s on the H100 SXM, from ``kubeflow_tpu_torch.topology``).
   The exact three-way bf16 split of an f32 tensor (``split3``, the
   tied head's backward on the card) at the LM's logit-gradient shape
   (16384 x 32768) and a ragged width, bit for bit against its twin.
2. serve: the flagship at full width from a seeded init, through
   ``make_engine(max_batch=8, max_len=2048)`` and its ``Scheduler``
   thread: 8 streamed requests (6 greedy, 2 sampled; prompts of 256 to
   1024 tokens; one exact-prompt pair and one extended-prompt pair for
   the prefix cache), 64 new tokens each. Greedy streams must equal the
   port's ``generate``; every kernel's launch counter must rise; the
   prefill and first decode-step logits with kernels (bf16) must agree
   with the plain path in f32.
3. int8: C1 first, an int8 KV cache at capacity 15 (each layer's
   scale slice 120 bytes past the last) through ``generate`` on the card,
   equal to the same call on the CPU; then ``quantize_decode_params`` of
   the serve params through a fresh engine with the launch counters
   zeroed: the 8 requests stream equal to ``generate(quantize_weights=
   True)``, the GEMV and the fused QKV+RoPE launch on int8 weights, and
   the prefill and first-decode logits agree with the f32 plain path on
   the dequantised weights (w8 * scale) within TOL_LOGITS.
4. gateway: a fresh engine behind ``InferenceGateway``; the 8 requests
   over HTTP from 8 client threads at once: every SSE frame parses and
   every stream equals the serve phase's; one ``stream: false`` request,
   one 400, ``/healthz`` and ``/readyz``; ``/metrics`` read back with the
   port's own parser (``inference_ttft_seconds`` counts every request);
   client-side TTFT and inter-token gaps. Then the pod entrypoint,
   ``python -m kubeflow_tpu_torch.serving`` at the flagship's dims as its
   own process: ready, one greedy request equal to ``generate``, exit 0
   on SIGTERM.
5. trace: the same requests on a fresh engine under ``torch.profiler``:
   device time per kernel and the device's idle share; then again on the
   int8 weights (``trace_int8``).
6. train: the 8x1024 MHA LM that ``bench.py``'s ``lm`` mode trains
   (vocab 32768, bf16 compute, f32 parameters from seed 0, AdamW with a
   bf16 first moment) at batch 4 x 2048 tokens: the step-0 loss and
   gradients of the kernel path (flash kernels; the dense products and
   the tied head on tensor cores, the head's gradient through
   ``split3``) against ``build_lm(use_flash=False)`` with its products
   widened to f32 (``widened_products``), and the tensor-core products
   alone against the same plain path; then 6 steps of
   ``make_lm_train_step`` on one fixed batch (8 launches of each flash
   kernel, 48 dense and 1 head tensor-core products and 1 split a step,
   finite and falling losses), then one more step under
   ``torch.profiler``.
7. ckpt: the train config through ``run_with_checkpointing`` on a seeded
   stream of 8 distinct batches, checkpoints (1.34 GB a step) in a
   directory under ``kubeflow_tpu_torch/build/`` that the run removes at
   its end. Run A takes 8 steps with a background save every 2 (2 kept);
   run B, from a fresh state and directory, is sent SIGTERM by its batch
   iterator while step 3 is in flight and must return preempted with
   step 3 committed by a synchronous save; run C, a fresh state of
   another seed, resumes from B's directory (``realign_batches``) and
   runs to step 8. Gates: the state C starts from equals B's saved state
   leaf by leaf (``torch.equal``); C's losses at steps 4-8 equal A's
   within 1e-4 relative (whether bit-equal is printed); 8 launches of
   each flash kernel per step over the three runs; a byte flipped in the
   newest step's shard makes ``restore_latest_valid`` fall back to the
   step before it. Printed: checkpoint bytes, a save's blocking
   milliseconds (the snapshot) and seconds and GB/s, a restore's
   seconds, and the step time with and without a save in flight.
8. pod_ckpt: ``python -m kubeflow_tpu_torch.serving`` with
   ``KFT_SERVING_MODEL_DIR`` at run C's directory and the train config
   (bf16; the f32 checkpoint is cast on restore). Gates: the pod is
   ready and one greedy request equals ``generate`` on
   ``restore_latest_valid({"params": template})``'s params; after a
   newer step is committed (another seed's parameters, so the tokens
   change), ``POST /v1/admin/swap`` answers 200 with it,
   ``inference_model_swap_total`` reads 1 and the same request equals
   ``generate`` on the new step; the pod exits 0 on SIGTERM, and the
   launch counts it logs at exit (counted in the pod process from its
   gateway's start, so over the two requests at the MHA shapes) show
   every serving kernel launched. Printed: ready and restore seconds,
   TTFT, swap seconds, the pod's launches.

9. long: ``bench.py``'s long mode (``KFT_BENCH_MODE=long``) on the
   train config at batch 1. Step 0 at S=8192 twice from one seeded
   state and batch, with ``loss_impl="auto"`` (the fused vocab-tiled
   loss) and ``"dense"``: the losses within 1e-3 relative, every leaf's
   gradient (read from the optimizer) within TRAIN_GRAD_TOL in relative
   norm, and the fused step's ``max_memory_allocated`` below the dense
   step's. Then, from the fused state, 4 steps at S=8192, 2 at S=32768
   and 2 at S=8192 with a 1024-token window: finite losses and 8
   launches of each flash kernel a step (counters zeroed before each
   run). Printed: step ms, tokens/s and peak memory of each, and one
   more step of each under ``torch.profiler``.
10. resnet: ``bench.py``'s primary section: ResNet-50 at batch 256,
   224x224 bf16 images, 1000 classes, label smoothing 0.1,
   ``make_optimizer()``, seed 0. First a resnet18 (width 8, f32, 32x32)
   on the card against the same model on the CPU, forward and one step,
   with TF32 off (cuDNN allows TF32 for f32 convolutions by default).
   Then the bf16 step-0 loss against the f32 model's on the same
   parameters and batch (TF32 off), 10 steps on one batch (finite and
   falling losses, ``batch_stats`` moved), an eval step, and a checkpoint
   saved and restored leaf by leaf equal (``batch_stats`` and the SGD
   trace included). Printed: images/s, step ms, MFU
   (3 x forward FLOPs x images/s over the card's peak), peak memory, and one
   step under ``torch.profiler``.

11. spec (run right after serve, on its params; 11-12 print there):
   ``speculative_generate`` at bench.py's two speculative
   sections on the serve params (GQA flagship, bf16, seed 0): a 64-token
   random segment (numpy seed 0) tiled to 1024 tokens, 256 new, and to
   8192, 128 new; draft 8, n-gram 3; each greedy and sampled (T 0.8,
   seed 5), beside ``generate`` on the same call. The verify chunk's
   dense products and ``generate``'s single-token kernels round
   differently, so the streams need not match bit for bit; instead
   (gate 1) at the first token where a stream leaves ``generate``'s,
   ``generate``'s own scores there (replayed call by call, plus T times
   that step's Gumbel row when sampling) put the two tokens within
   TOL_LOGITS, and (gate 2) every emitted token's score in one f32 plain
   full-sequence forward of prompt + output is within TOL_LOGITS of its
   position's best. The prefill launches the flash kernel once a layer.
   Printed: tokens/s, accept rate, tokens per verify, verify calls,
   ``decode_step_ms``, and ``generate``'s tokens/s on the same call.
12. spec_serve: ``make_engine(max_batch=8, max_len=2048,
   spec_ngram=True)`` with its ``Scheduler`` on 8 tiled prompts of 256
   to 1024 tokens (6 greedy, 2 sampled), 64 new tokens each; gates 1
   and 2 on every stream; the verify and commit histograms count every
   verify; then the same requests on a lockstep engine, whose streams
   must equal ``generate``. Printed: decode tokens/s of both engines.
13. moe: bench.py's ``lm_moe`` sections: the train config with 8
   experts in every 2nd block (369,148,928 parameters), f32 parameters,
   bf16 compute, AdamW with a bf16 first moment, batch 4 x 2048, seed 0,
   capacity 320 a row. Step 0 of the kernel path against
   ``build_lm(use_flash=False)`` with the kernel pass's expert choices
   pinned to the plain pass's (the aux term included: loss within 1e-2,
   each leaf's gradient within TRAIN_GRAD_TOL; the flipped choices and
   the unpinned worst leaf printed); 6 steps of top-k
   routing, then 6 of expert choice, each from a fresh state: per-expert
   load within the capacity, no slot held twice, finite and falling
   losses, 8 launches of each flash kernel a step; one step of each
   under ``torch.profiler`` and the layer's forward parts timed. Then a
   fresh bf16 init of the top-k config through ``make_engine``, which
   must return the ``GenerateFallbackEngine``: 4 requests (prompts 256
   to 1024, 32 new, one sampled) equal to ``generate`` bit for bit, every
   serving kernel launched; and MoE decode against the f32 plain path:
   prefill and first-step logits within TOL_LOGITS at every position
   routed alike on both paths, at most 1% of token-layer routings
   differing.
14. parallel (last): ``initialize_from_env`` on a single replica's env
   (``slice_env_for_rank(..., 0, 1)``) must form no world; ``make_mesh
   (MeshSpec())`` then forms an NCCL world of one over the card (backend,
   world size and mesh shape printed). The train phase's LM (8x1024 MHA,
   vocab 32768, bf16 compute, f32 parameters from seed 0, batch 4 x 2048)
   through ``make_lm_train_step(mesh)`` against the meshless step: the
   step-0 loss within 1e-5 relative and every leaf after the step within
   1e-5 in relative norm (whether bit-equal is printed); then 6 steps of
   each, timed, with 8 launches of each flash kernel a mesh step.
   ResNet-50 at the resnet phase's shape (batch 256 of 224x224 bf16,
   ``make_optimizer()``, seed 0): one step on the mesh against the
   meshless one (loss, params and ``batch_stats`` within 1e-5; the
   mesh step runs each BatchNorm kernel once a norm, 53 each, on the
   group path: the moments all-reduced between the passes), then 3
   timed steps of each. The ring's hop arithmetic at full width (B=1,
   H=8, Hkv=2, S=8192 as 4 shards of 2048, d=128, bf16): ``ring_hop``
   over the 4 source shards of every query shard in one process, dead
   hops skipped, causal, window 1024 and packed documents across shard
   boundaries, each against ``mha_reference`` in f32 within TOL_BF16;
   the device ms of one hop. The ring's collectives are held on the CPU
   (gloo worlds in ``tests/test_torch_ring.py``): one card runs one NCCL
   rank.
15. mesh_ckpt (on the parallel phase's world of one, before it ends):
   the train config through ``run_with_checkpointing(mesh=)`` on a seeded
   stream of 4 batches, checkpoints saved every 2 steps under
   ``kubeflow_tpu_torch/build/``, the batch iterator sending SIGTERM
   while step 3 is in flight; a fresh mesh state of another seed resumes
   from the step-3 checkpoint and runs step 4. Gates: step 3 committed
   by the preempted run, its manifest stamped with the mesh's shape; the
   state the resume starts from equals the saved state leaf by leaf; the
   resumed run's final state within 1e-5 (relative norm, every leaf) of
   an uninterrupted mesh run's (whether bit-equal is printed); 8 launches
   of each flash kernel a step over the three runs. Then the mesh
   checkpoint restored into a whole template and, saved again from it,
   restored onto a mesh template: each equal to its source leaf by leaf.
   Then the MoE config (phase 13's) steps once on the mesh and once
   without, from seed 0 on one batch: the loss and every leaf within
   1e-5 (whether bit-equal is printed), 8 launches of each flash kernel
   in the mesh step; 3 timed steps of each. Printed: a mesh save's
   blocking ms and seconds, the restores' seconds, step ms.
16. pipeline (on the same world of one, before it ends; one card is one
   NCCL rank, so pp = 1): the train config's LM at full width and depth
   through ``make_pp_lm_train_step`` with batch 4 x 2048 as M = 4
   microbatches of 1 x 2048, on each schedule: gpipe, gpipe with remat,
   1f1b, interleaved with 2 virtual stages, 1f1b with 2 virtual stages,
   each from ``create_pp_lm_state`` with seed 0 (the meshless LM's
   weights, stacked). Gates: the step-0 loss within TRAIN_LOSS_TOL and
   every leaf's gradient within TRAIN_GRAD_TOL (relative norm) of the
   meshless ``make_lm_train_step`` on the same weights and batch; the
   losses falling over 3 steps; the flash kernels' launches a step as
   reckoned (PIPELINE_SCHEDULES: the forward L x M = 32, plus 32 for the
   backward's recompute under remat and 1F1B, plus the forward units of
   every chunk but the last under interleaved 1F1B; dq and dk/dv 32).
   Then the engines alone on a toy stage (8 tanh layers at dim 1024,
   M = 16 microbatches of 2048 rows): 1F1B's step peak above what was
   allocated before must be below gpipe's. Printed: step ms of each
   schedule against the meshless step, and each step's peak memory.
17. hooks (on the same world of one, before it ends): the train config
   (batch 4 x 2048, seed 0) through ``run_with_checkpointing`` with the
   train loop's hooks: a ``StepTelemetry`` (FLOPs a sequence from
   ``train_flops_per_sequence``: 6 x the product parameters x S + 6 x L x
   S^2 x D), a ``GoodputMeter``, the ``GoodputAnnotationPublisher`` on a
   recording stand-in for the API, and a ``CheckpointCadenceActuator``
   (x0.25 of an 8-step cadence) fed a critical firing alert after step 2;
   SIGTERM while step 4 is in flight, then a fresh state of another seed
   resumes to step 6 with ``GoodputMeter.from_snapshot``. Gates: one
   telemetry record a step, each one's MFU its tokens x FLOPs over the
   card's peak from the port's table; saves at 2 (the tightened cadence)
   and 4 (the grace save), then 6; the restore charged as downtime and
   the gap between the runs; 0 < goodput <= 1; the last annotation the
   meter's ratio to 4 places; 8 launches of each flash kernel a step.
   Printed: the hooked step's ms beside the same state's plain
   ``run_steps`` ms. Then ResNet-50 one mesh step at fsdp = 1 (the
   per-block gathers pass the weights through) from seed 0 on the
   parallel phase's batch: its loss equal to that phase's mesh and
   meshless losses, which must have been bit-equal.
18. bench: ``python -m kubeflow_tpu_torch.bench`` in its own process at
   its defaults (every section, full width). Gates: one JSON line, every
   record valid by the port's ``validate_record``, no
   ``bench_extra_error``, the provenance naming the card, torch and
   CUDA, no ``vs_baseline``, every kernel launched in the child (its
   ``kernel_launches``). Printed: each section's value and step ms, the
   phase's wall time.

Output: one JSON line per phase, the ``{"kernels": [...]}`` summary,
the card's name and power limit, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# The card's dense bf16 tensor-core peak, from the port's table
# (``kubeflow_tpu_torch.topology``), set in ``main``.
BF16_FLOPS_PER_S = None
# Outputs are held element by element: |out - ref| <= rtol * |ref| +
# atol * rms(ref row), the RMS taken over the last axis (one token's or
# one head's row), so a late attention row of magnitude ~0.05 is held as
# tightly as an early one of magnitude ~3. (rtol, atol) per output type:
# f32 outputs differ only in summation order; bf16 outputs by one ulp of
# the final rounding (at most 2^-7 relative) plus rounding at a different
# point inside (the GEMV's y before the residual add, RoPE's operands,
# attention's softmax weights, each within 2^-9 relative), which stays
# under a few ulps of the row's RMS.
# A row's RMS is floored at ROW_RMS_FLOOR of the whole output's RMS: a
# row whose exact value is zero comes out of any two summation orders as
# different f32 residue (~1e-7; dq of a row with one live key, where p = 1
# and dp = delta cancel), which its own RMS cannot scale; the floor holds
# it at the output's scale instead. Rows of real outputs sit far above it
# (a late attention row ~1/60 of an early one).
TOL_F32 = (1e-5, 1e-4)
TOL_BF16 = (2.0 ** -7, 2.0 ** -5)
ROW_RMS_FLOOR = 2.0 ** -8
TOL_LOGITS = 0.25   # bf16 end to end vs f32, 8 layers, |logits| ~ O(5)
# Prompt lengths of the serve phase (see serve_requests for the layout).
SERVE_LENGTHS = (1024, 768, 512, 256, 640, 384, 128)
NEW_TOKENS = 64
SERVE_KERNELS = ("flash_attention", "gemv", "qkv_rope", "decode_attention")
TRAIN_KERNELS = ("flash_attention", "flash_dq", "flash_dkv")
# Kernels an LM train step launches once, whatever its depth: the split
# of the tied head's f32 logit gradient.
STEP_KERNELS = ("split3",)
# Gateway phase: the longest any one HTTP call may take, and how long the
# pod entrypoint may take to answer /readyz (torch import, card init, a
# seeded init of 121M parameters, the kernel library loaded).
GATEWAY_TIMEOUT_S = 300
POD_READY_TIMEOUT_S = 300
# Train phase: bench.py's lm mode (KFT_BENCH_MODE=lm) at its defaults.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 6
# Step-0 gradients of the kernel path (bf16 flash, o/p/ds rounded to
# bf16) against the plain path (f32 softmax attention), in relative norm
# per parameter leaf, and the loss in absolute terms. On an H100 (700 W)
# the worst leaf read 0.0217 (a k_proj kernel) with sound kernels, and 0.169
# to 1.0 with each of three planted backward faults
# (testing/torch_fault_check.sh). The sound reading is the scheme's bf16
# rounding, not the kernels: delta = rowsum(dO * O) from a bf16 O alone
# gives 0.0145, and two exact f32 backwards that sum in different orders
# already differ by 0.0089 through this bf16 model. step0_readings prints
# those witnesses; PERF.md has them.
TRAIN_GRAD_TOL = 5e-2
TRAIN_LOSS_TOL = 1e-2


def _fail(msg: str) -> None:
    raise AssertionError(msg)


def check_close(out, ref, tol) -> tuple[float, float]:
    """Max abs error, and the largest share of its limit any element
    used (above 1 fails; NaN fails)."""
    import torch

    rtol, atol = tol
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    rms = torch.maximum(r.pow(2).mean(-1, keepdim=True).sqrt(),
                        ROW_RMS_FLOOR * r.pow(2).mean().sqrt())
    limit = rtol * r.abs() + atol * rms
    used = torch.where(diff == 0, torch.zeros_like(diff), diff / limit)
    return float(diff.max()), float(used.max())


# --------------------------------------------------------------- timing


class Timer:
    """Median DEVICE time of ``fn`` over repeated launches: the L2 cache
    is flushed (a 64 MB write) before each, so weights come from HBM as
    in a real decode step that streams 243 MB, and a ~2 ms device spin
    runs ahead of the start event, so the host has queued ``fn`` before
    the card reaches it and its launch cost on the host is not counted."""

    SPIN_CYCLES = 3_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 30, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def same_bits(torch, kernel, name, out, launch, launch_row) -> None:
    """Fail unless a second launch, and each row launched alone
    (``launch_row(i)``, a batch of one), give ``out``'s bits."""
    again = launch()
    rows = torch.cat([launch_row(i) for i in range(out.shape[0])])
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        _fail(f"{kernel}[{name}]: two launches gave different bits")
    if not torch.equal(out, rows):
        _fail(f"{kernel}[{name}]: a row launched alone differs from its "
              "row of the batched launch")


# -------------------------------------------------------------- kernels


def kernel_phase(torch, timer):
    """Every kernel against its twin; returns {kernel: [case dicts]}."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.attention import flash_attention, mha_reference
    from kubeflow_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_reference,
    )
    from kubeflow_tpu_torch.ops.decode_qkv import qkv_rope, qkv_rope_reference
    from kubeflow_tpu_torch.ops.gemv import gemv, gemv_reference
    from kubeflow_tpu_torch.ops.split import split3, split3_reference

    gen = torch.Generator(device="cuda").manual_seed(1234)
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(bf16)

    def quantize_cols(w, axis):
        wf = w.float()
        scale = wf.abs().amax(dim=axis).clamp_min(1e-12) / 127.0
        w8 = torch.clamp(torch.round(wf / scale.unsqueeze(axis)), -127,
                         127).to(torch.int8)
        return w8.contiguous(), scale.contiguous()

    results = {"gemv": [], "qkv_rope": [], "decode_attention": [],
               "flash_attention": [], "flash_dq": [], "flash_dkv": [],
               "split3": [], **{name: [] for name in BN_KERNELS}}

    def record(kernel, name, out, ref, tol, kernel_fn, plain_fn,
               library_fn, nbytes, flops, iters=30, **extra):
        err, used = 0.0, 0.0
        for o, r, t in zip(out, ref, tol) if isinstance(out, tuple) else [
                (out, ref, tol)]:
            e, u = check_close(o, r, t)
            if not u <= 1.0:
                _fail(f"{kernel}[{name}] disagrees with its plain version: "
                      f"an element used {u} of its limit (rtol, atol x row "
                      f"rms = {t}); max_abs_err {e}")
            err, used = max(err, e), max(used, u)
        b_ms, b_by = bound(nbytes, flops)
        tol0 = tol[0] if isinstance(out, tuple) else tol
        results[kernel].append({
            "case": name, "max_abs_err": err, "tol_used": used,
            "rtol": tol0[0], "atol_rms": tol0[1],
            "ms": timer(kernel_fn, iters), "plain_ms": timer(plain_fn, iters),
            "library_ms": timer(library_fn, iters) if library_fn else None,
            "bound_ms": b_ms, "bound_by": b_by, **extra})

    # ---- gemv: the decode step's projections and the tied head (R=8).
    # The int8 cases launch as ``models.decoding._mm`` does: with a
    # residual the kernel takes the scale; without one it takes none
    # (the model multiplies ``y * scale`` after), so the no-residual
    # cases hold the kernel's own output, the f32 dot, to its twin.
    r = 8
    for name, k, n, residual, transpose, int8 in [
            ("proj_residual", 1024, 1024, True, False, False),
            ("up", 1024, 4096, False, False, False),
            ("down_residual", 4096, 1024, True, False, False),
            ("tied_head", 1024, 32768, False, True, False),
            ("int8_residual", 1024, 4096, True, False, True),
            ("int8_up", 1024, 4096, False, False, True),
            ("int8_tied_head", 1024, 32768, False, True, True)]:
        x = randn(r, k)
        w = randn(*((n, k) if transpose else (k, n)), std=k ** -0.5)
        scale = None
        if int8:
            w, scale = quantize_cols(w, 1 if transpose else 0)
            if not residual:
                scale = None
        res = randn(r, n) if residual else None
        out = gemv(x, w, scale, res, transpose_w=transpose)
        torch.cuda.synchronize()
        ref = gemv_reference(x, w, scale, res, transpose_w=transpose)
        extra = {}
        if name in ("tied_head", "down_residual", "int8_tied_head"):
            # No atomics: the K slices meet in a fixed order.
            again = gemv(x, w, scale, res, transpose_w=transpose)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                _fail(f"gemv[{name}]: two launches gave different bits")
            extra["bitwise_deterministic"] = True
        wmat = w.t() if transpose else w
        library = (None if int8 else (lambda x=x, wmat=wmat:
                                      torch.matmul(x, wmat)))
        nbytes = (x.numel() * 2 + w.numel() * w.element_size()
                  + (n * 4 if scale is not None else 0)
                  + (r * n * 2 if residual else 0)
                  + r * n * (2 if residual else 4))
        record("gemv", name, out, ref, TOL_BF16 if residual else TOL_F32,
               lambda: gemv(x, w, scale, res, transpose_w=transpose),
               lambda: gemv_reference(x, w, scale, res,
                                      transpose_w=transpose),
               library, nbytes, 2 * r * k * n, **extra)

    # ---- qkv_rope: (8, 1024) @ (1024, 1536), 10 rope heads, mixed
    # positions; plus a ragged width (N/2 not a multiple of the block's
    # 32 pairs) and int8, so every output column is proven written; and
    # the train config's MHA width (1024, 3072), 16 rope heads, which the
    # pod serving a training checkpoint runs.
    for name, k, hd, heads, kv, int8 in [
            ("flagship", 1024, 128, 8, 2, False),
            ("ragged_width", 1024, 40, 3, 1, False),
            ("int8", 1024, 128, 8, 2, True),
            ("mha", 1024, 128, 8, 8, False)]:
        n = (heads + 2 * kv) * hd
        x = randn(r, k)
        w = randn(k, n, std=k ** -0.5)
        scale = None
        if int8:
            w, scale = quantize_cols(w, 0)
        pos = torch.tensor([0, 1, 17, 255, 256, 1000, 1279, 513],
                           dtype=torch.int32, device="cuda")
        kw = dict(head_dim=hd, rope_heads=heads + kv)
        out = qkv_rope(x, w, pos, scale, **kw)
        torch.cuda.synchronize()
        ref = qkv_rope_reference(x, w, pos, scale, **kw)
        # No atomics, and the K split depends on K and N only: two
        # launches give the same bits, and so does each row alone.
        same_bits(torch, "qkv_rope", name, out,
                  lambda: qkv_rope(x, w, pos, scale, **kw),
                  lambda i: qkv_rope(x[i:i + 1].clone(), w,
                                     pos[i:i + 1].clone(), scale, **kw))
        nbytes = (x.numel() * 2 + w.numel() * w.element_size() + r * 4
                  + (n * 4 if int8 else 0) + r * n * 2)
        record("qkv_rope", name, out, ref, TOL_BF16,
               lambda: qkv_rope(x, w, pos, scale, **kw),
               lambda: qkv_rope_reference(x, w, pos, scale, **kw),
               None, nbytes, 2 * r * k * n, bitwise_deterministic=True,
               batch_invariant=True)

    # ---- decode attention: B=8, H=8, Hkv=2, hd=128, capacity 1280; and
    # the serve phase's own shape: capacity max_len=2048, each slot at
    # its request's last decode position (prompt length + 62); and that
    # shape with 8 kv heads (MHA), the train config the pod serves from
    # its checkpoint.
    b, h, hkv, hd = 8, 8, 2, 128
    for name, cap, window, rolling, int8, kv in [
            ("linear", 1280, None, False, False, hkv),
            ("int8", 1280, None, False, True, hkv),
            ("window", 1280, 256, False, False, hkv),
            ("rolling", 512, 512, True, False, hkv),
            ("serve_shape", 2048, None, False, False, hkv),
            ("mha_serve_shape", 2048, None, False, False, h)]:
        q = randn(b, h, 1, hd)
        kc, vc = randn(b, kv, cap, hd), randn(b, kv, cap, hd)
        ks = vs = None
        if int8:
            ks = (kc.float().abs().amax(-1, keepdim=True) / 127.0)
            vs = (vc.float().abs().amax(-1, keepdim=True) / 127.0)
            kc = torch.clamp(torch.round(kc.float() / ks), -127,
                             127).to(torch.int8)
            vc = torch.clamp(torch.round(vc.float() / vs), -127,
                             127).to(torch.int8)
        if rolling:
            pos_list = [0, 100, 511, 512, 700, 1279, 2000, 333]
        elif name.endswith("serve_shape"):
            n = SERVE_LENGTHS  # serve_phase's prompts, in its order
            pos_list = [p + 62 for p in (n[0], n[1], n[2], n[3], n[4], n[0],
                                         n[5], n[5] + n[6])]
        else:
            pos_list = [0, 100, 255, 256, 700, 1279, 1000, 513]
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        kw = dict(window=window, k_scale=ks, v_scale=vs, rolling=rolling)
        out = decode_attention(q, kc, vc, pos, **kw)
        torch.cuda.synchronize()
        ref = decode_attention_reference(q, kc, vc, pos, **kw)

        def one_row(i, q=q, kc=kc, vc=vc, pos=pos, kw=kw):
            rows_kw = {key: (val[i:i + 1].clone()
                             if isinstance(val, torch.Tensor) else val)
                       for key, val in kw.items()}
            return decode_attention(q[i:i + 1].clone(),
                                    kc[i:i + 1].clone(),
                                    vc[i:i + 1].clone(),
                                    pos[i:i + 1].clone(), **rows_kw)

        # The slices meet in rank order, and a row's slices depend on its
        # own live range only: the bits of two launches, and of each row
        # alone at B=1, are the batched call's.
        same_bits(torch, "decode_attention", name, out,
                  lambda: decode_attention(q, kc, vc, pos, **kw), one_row)
        live = []
        for p in pos_list:
            if rolling:
                live.append(min(p, cap - 1) + 1)
            else:
                lo = 0 if window is None else max(p - window + 1, 0)
                live.append(min(p, cap - 1) - lo + 1)
        rows = sum(live) * kv
        item = 1 if int8 else 2
        nbytes = (q.numel() * 4 + rows * hd * item * 2
                  + (rows * 8 if int8 else 0))
        flops = 4 * sum(live) * h * hd
        library = None
        if not int8:
            cols = torch.arange(cap, device="cuda")[None, :]
            rows_ = pos[:, None].long()
            if rolling:   # slot -> global position on the ring
                keep = rows_ - torch.remainder(rows_ - cols, cap) >= 0
            else:
                keep = cols <= rows_
                if window is not None:
                    keep &= cols > rows_ - window
            mask = keep[:, None, None, :]
            library = (lambda q=q, kc=kc, vc=vc, mask=mask:
                       F.scaled_dot_product_attention(
                           q, kc, vc, attn_mask=mask, enable_gqa=True))
        record("decode_attention", name, out, ref, TOL_BF16,
               lambda: decode_attention(q, kc, vc, pos, **kw),
               lambda: decode_attention_reference(q, kc, vc, pos, **kw),
               library, nbytes, flops, bitwise_deterministic=True,
               batch_invariant=True)

    # ---- flash forward: the empty-cache prefill, B=1, S=1024, and the
    # speculative p8k section's prefill at S=8192 (no lse).
    d = 128
    for name, s, window in [("causal", 1024, None), ("window", 1024, 256),
                            ("p8k", 8192, None)]:
        q = randn(1, h, s, d)
        kk, vv = randn(1, hkv, s, d), randn(1, hkv, s, d)
        out = flash_attention(q, kk, vv, causal=True, window=window)
        torch.cuda.synchronize()
        ref = mha_reference(q, kk, vv, causal=True, window=window)
        pairs = sum(min(i + 1, window or s) for i in range(s))
        if window is None:
            library = (lambda q=q, kk=kk, vv=vv:
                       F.scaled_dot_product_attention(
                           q, kk, vv, is_causal=True, enable_gqa=True))
        else:
            idx = torch.arange(s, device="cuda")
            band = ((idx[None, :] <= idx[:, None])
                    & (idx[None, :] > idx[:, None] - window))
            library = (lambda q=q, kk=kk, vv=vv, band=band:
                       F.scaled_dot_product_attention(
                           q, kk, vv, attn_mask=band, enable_gqa=True))
        record("flash_attention", name, out, ref, TOL_BF16,
               lambda: flash_attention(q, kk, vv, causal=True,
                                       window=window),
               lambda: mha_reference(q, kk, vv, causal=True, window=window),
               library, (q.numel() * 2 + kk.numel() * 4 + q.numel() * 2),
               4 * h * d * pairs)
    train_attention_cases(torch, randn, record)

    # ---- split3: the LM train step's (tokens, vocab) f32 logit
    # gradient, and a width that is no multiple of 4 (the kernel's
    # one-element path). Softmax-like values: ~1/(vocab x tokens), one
    # large negative entry a row. Exact: the kernel's bits are the twin's.
    for name, rows, cols in [("lm_head_grad", 16384, 32768),
                             ("ragged", 2048, 4099)]:
        g = torch.rand(rows, cols, generator=gen, device="cuda") * (
            2.0 / (rows * cols))
        hot = torch.randint(0, cols, (rows,), generator=gen, device="cuda")
        g[torch.arange(rows, device="cuda"), hot] = -1.0 / rows
        out = split3(g)
        torch.cuda.synchronize()
        if not torch.equal(out, split3_reference(g)):
            _fail(f"split3[{name}] differs from its twin")
        again = split3(g)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            _fail(f"split3[{name}]: two launches gave different bits")
        b_ms, b_by = bound(rows * cols * 10, 0)
        results["split3"].append({
            "case": name, "max_abs_err": 0.0, "tol_used": 0.0,
            "bit_equal": True, "ms": timer(lambda g=g: split3(g)),
            "plain_ms": timer(lambda g=g: split3_reference(g)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
        del g, hot, out, again
    batch_norm_cases(torch, timer, gen, results)
    return results


# BatchNorm kernels: ResNet-50's stem norm (its ReLU after) and a stage-4
# block's last norm (residual sum and ReLU after) at batch 256, 224x224,
# bf16. The apply and dx passes must give the twins' bits given the
# kernels' statistics and sums; the statistics and sums are held to
# BN_SUM_RTOL (tests/test_torch_cuda.py states why).
BN_KERNELS = ("bn_stats", "bn_apply", "bn_grad_sums", "bn_dx")
ALL_KERNELS = SERVE_KERNELS + TRAIN_KERNELS + STEP_KERNELS + BN_KERNELS
BN_CASES = (("stem", (256, 64, 112, 112), False),
            ("stage4", (256, 2048, 7, 7), True))
BN_SUM_RTOL = 1e-5


def batch_norm_cases(torch, timer, gen, results) -> None:
    """Each BatchNorm pass at the cases' shapes against its twin, timed
    beside its bound (each tensor it streams once over HBM), the twin's
    time and, as the yardstick, PyTorch's own kernel for the same work:
    ``torch.batch_norm_stats`` on the stats row,
    ``torch.batch_norm_backward_reduce`` (its two sums, no ReLU mask) on
    the grad-sums row, and ``F.batch_norm`` (cuDNN) on the others, its
    whole forward on the apply row, its whole backward on the dx row.
    ``max_abs_err`` is measured: 0 for the apply and dx passes, which
    are held bit for bit, the largest difference from the twin for the
    statistics and the sums."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import batch_norm as bn

    for name, (n, c, h, w), residual in BN_CASES:
        def act(std=1.0):
            return (torch.randn((n, h, w, c), generator=gen, device="cuda")
                    * std).to(torch.bfloat16).permute(0, 3, 1, 2)

        x, g = act(2.0), act()
        res = act() if residual else None
        scale, bias = (torch.randn(c, generator=gen, device="cuda")
                       for _ in range(2))
        run_mean = torch.zeros(c, device="cuda")
        run_var = torch.ones(c, device="cuda")
        moments = bn.stats(x)
        want = bn.moments_reference(x)
        stats_err = float((moments - want).abs().max())
        stats_used = max(
            float(((moments[0] - want[0]).abs() / want[1].sqrt()).max()),
            float(((moments[1] - want[1]).abs() / want[1]).max())
        ) / BN_SUM_RTOL
        out, saved, _, _ = bn.apply(x, moments, scale, bias, run_mean,
                                    run_var, res, True)
        mean, var, rstd = saved
        if not torch.equal(out, bn.normalize_reference(
                x, mean, rstd * scale, bias, res, True)):
            _fail(f"bn_apply[{name}] differs from its twin given the "
                  "kernel's statistics")
        masked = bn.masked_grad(g, out)
        dbias, dscale = bn.grad_sums(g, x, out, saved)
        want_b, want_s = bn.grad_sums_reference(masked, x, mean, rstd)
        sums_err = max(float((dbias - want_b).abs().max()),
                       float((dscale - want_s).abs().max()))
        xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
        tiny = torch.finfo(torch.float32).tiny   # a channel the ReLU zeroes
        sums_used = max(
            float(((dbias - want_b).abs()
                   / masked.float().abs().sum(dim=(0, 2, 3)).clamp_min(tiny)
                   ).max()),
            float(((dscale - want_s).abs()
                   / (masked.float() * xhat).abs().sum(dim=(0, 2, 3))
                   .clamp_min(tiny)).max())
        ) / BN_SUM_RTOL
        del xhat
        count = n * h * w
        dx, dres = bn.dx(g, x, out, saved, scale, dbias, dscale, count,
                         residual)
        if not torch.equal(dx, bn.dx_reference(masked, x, mean, var, rstd,
                                               scale, dbias, dscale, count)):
            _fail(f"bn_dx[{name}] differs from its twin given the "
                  "kernel's sums")
        if residual and not torch.equal(dres, masked):
            _fail(f"bn_dx[{name}]: the residual's gradient is not g'")
        if not stats_used <= 1.0 or not sums_used <= 1.0:
            _fail(f"bn[{name}]: statistics at {stats_used}, backward sums "
                  f"at {sums_used} of their summation-order limit")
        again = (bn.stats(x), bn.apply(x, moments, scale, bias, run_mean,
                                       run_var, res, True)[0],
                 *bn.grad_sums(g, x, out, saved),
                 bn.dx(g, x, out, saved, scale, dbias, dscale, count,
                       residual)[0])
        for a, b in zip(again, (moments, out, dbias, dscale, dx)):
            if not torch.equal(a, b):
                _fail(f"bn[{name}]: two launches gave different bits")
        del again

        # cuDNN's train-mode BatchNorm over the same tensor, forward and
        # backward (scale and bias gradients included).
        xl = x.detach().requires_grad_()
        wl = scale.detach().requires_grad_()
        bl = bias.detach().requires_grad_()

        def library_fwd():
            return F.batch_norm(xl, run_mean.clone(), run_var.clone(), wl, bl,
                                training=True, momentum=0.1, eps=bn.EPSILON)

        y_lib = library_fwd()

        def library_bwd():
            return torch.autograd.grad(y_lib, (xl, wl, bl), g,
                                       retain_graph=True)

        def library_stats():
            return torch.batch_norm_stats(x, bn.EPSILON)

        def library_sums():
            return torch.batch_norm_backward_reduce(g, x, mean, rstd, scale,
                                                    True, False, False)

        elem = x.numel() * x.element_size()
        acts = 1 + residual
        rows = {
            "bn_stats": (lambda: bn.stats(x), lambda: bn.moments_reference(x),
                         library_stats, elem, stats_err, stats_used),
            "bn_apply": (
                lambda: bn.apply(x, moments, scale, bias, run_mean, run_var,
                                 res, True),
                lambda: bn.apply_reference(x, moments, scale, bias, res,
                                           True),
                library_fwd, (acts + 1) * elem, 0.0, 0.0),
            "bn_grad_sums": (
                lambda: bn.grad_sums(g, x, out, saved),
                lambda: bn.grad_sums_reference(bn.masked_grad(g, out), x,
                                               mean, rstd),
                library_sums, 3 * elem, sums_err, sums_used),
            "bn_dx": (
                lambda: bn.dx(g, x, out, saved, scale, dbias, dscale, count,
                              residual),
                lambda: bn.dx_reference(bn.masked_grad(g, out), x, mean, var,
                                        rstd, scale, dbias, dscale, count),
                library_bwd, (4 + residual) * elem, 0.0, 0.0)}
        for kernel, (fn, plain, library, nbytes, err, used) in rows.items():
            b_ms, b_by = bound(nbytes, 0)
            results[kernel].append({
                "case": name, "shape": [n, c, h, w], "residual": residual,
                "max_abs_err": err, "tol_used": used,
                "bit_equal": kernel in ("bn_apply", "bn_dx"),
                "ms": timer(fn, 20), "plain_ms": timer(plain, 5),
                "library_ms": timer(library, 20) if library else None,
                "bound_ms": b_ms, "bound_by": b_by})
        del x, g, res, out, dx, dres, masked, xl, y_lib
        torch.cuda.empty_cache()


# (name, batch, heads, kv heads, seq, window, segmented): the training
# shape of the train phase first, then the other masks the kernels take.
TRAIN_ATTN_CASES = [
    ("train_causal", 4, 8, 8, 2048, None, False),
    ("gqa", 1, 8, 2, 1024, None, False),
    ("window", 1, 8, 8, 2048, 256, False),
    ("segments", 2, 8, 8, 2048, None, True),
    ("ragged", 1, 8, 8, 1000, None, False),
    # The long phase's shape (bench.py's long mode): B=1, MHA, S=8192.
    ("long", 1, 8, 8, 8192, None, False),
]


def packed_segments(torch, b, s, gen):
    """(b, s) int32 ids of packed documents of 200 to 900 tokens."""
    rows = []
    for _ in range(b):
        lengths = torch.randint(200, 901, (s // 200 + 1,), generator=gen)
        ends = torch.cumsum(lengths, 0)
        rows.append(torch.searchsorted(ends, torch.arange(s), right=True))
    return torch.stack(rows).to(torch.int32).cuda()


def live_pairs(torch, b, s, window, seg):
    """Live (row, key) pairs per head, summed over the batch: what the
    causal / window / document mask leaves of this run's inputs."""
    idx = torch.arange(s, device="cuda")
    keep = idx[None, :] <= idx[:, None]
    if window is not None:
        keep &= idx[None, :] > idx[:, None] - window
    if seg is None:
        return b * int(keep.sum())
    same = seg[:, :, None] == seg[:, None, :]
    return int((keep[None] & same).sum())


def sdpa_mask(torch, s, window, seg):
    """The boolean mask SDPA takes for a causal band and document ids,
    (1 or B, 1, S, S); None for plain causal (SDPA's ``is_causal``)."""
    if window is None and seg is None:
        return None
    idx = torch.arange(s, device="cuda")
    mask = idx[None, :] <= idx[:, None]
    if window is not None:
        mask &= idx[None, :] > idx[:, None] - window
    mask = mask[None, None]
    if seg is not None:
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
    return mask


def sdpa(F, q, k, v, mask):
    """One SDPA forward call, causal through ``is_causal`` or ``mask``."""
    if mask is None:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True)


def train_attention_cases(torch, randn, record):
    """The flash forward with lse and the dq / dk-dv kernels against their
    twins on every case of TRAIN_ATTN_CASES; SDPA's forward, and its
    backward (dq+dk+dv together, forward excluded), as the library
    calls."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops.attention import (
        _dkv,
        _dq,
        _forward,
        flash_dkv,
        flash_dkv_reference,
        flash_dq,
        flash_dq_reference,
        flash_forward,
        flash_forward_reference,
    )

    gen = torch.Generator().manual_seed(99)
    d = 128
    for name, b, h, hkv, s, window, segmented in TRAIN_ATTN_CASES:
        q, do = randn(b, h, s, d), randn(b, h, s, d)
        k, v = randn(b, hkv, s, d), randn(b, hkv, s, d)
        seg = packed_segments(torch, b, s, gen) if segmented else None
        kw = dict(causal=True, window=window, segment_ids=seg)
        pairs = live_pairs(torch, b, s, window, seg) * h
        # Timed past the public entries' segment-order check, a host sync
        # the train step makes once per batch, not once per launch.
        mask = (True, window, seg, d ** -0.5)
        out = flash_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        o, lse = flash_forward_reference(q, k, v, **kw)
        sdpa_in = sdpa_mask(torch, s, window, seg)
        record("flash_attention",
               "train_lse" if name == "train_causal" else f"{name}_lse",
               out, (o, lse), (TOL_BF16, TOL_F32),
               lambda: _forward(q, k, v, *mask, with_lse=True),
               lambda: flash_forward_reference(q, k, v, **kw),
               lambda: sdpa(F, q, k, v, sdpa_in),
               q.numel() * 2 * 2 + k.numel() * 4 + b * h * s * 4,
               4 * d * pairs, iters=10)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        library = sdpa_backward(torch, F, q, k, v, do, window, seg)
        row_bytes = b * h * s * 4 * 2     # lse and delta
        in_bytes = (q.numel() * 2 * 2 + k.numel() * 2 * 2 + row_bytes)
        dq = flash_dq(*args, **kw)
        torch.cuda.synchronize()
        record("flash_dq", name, dq, flash_dq_reference(*args, **kw),
               TOL_BF16, lambda: _dq(*args, *mask),
               lambda: flash_dq_reference(*args, **kw), library,
               in_bytes + q.numel() * 2, 6 * d * pairs, iters=10,
               library_computes="dq+dk+dv")
        dkv = flash_dkv(*args, **kw)
        torch.cuda.synchronize()
        record("flash_dkv", name, dkv, flash_dkv_reference(*args, **kw),
               (TOL_BF16, TOL_BF16), lambda: _dkv(*args, *mask),
               lambda: flash_dkv_reference(*args, **kw), library,
               in_bytes + k.numel() * 2 * 2, 8 * d * pairs, iters=10,
               library_computes="dq+dk+dv")


def sdpa_backward(torch, F, q, k, v, do, window, seg):
    """A function that runs SDPA's backward for (q, k, v) on a forward
    taken once here: one PyTorch call computing dq, dk and dv."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = sdpa(F, *leaves, sdpa_mask(torch, q.shape[2], window, seg))
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


# ---------------------------------------------------------------- serve


def flagship(torch):
    from kubeflow_tpu_torch.models.transformer import LMConfig

    return LMConfig(vocab=32768, layers=8, dim=1024, heads=8, kv_heads=2,
                    dtype=torch.bfloat16)


def serve_requests(torch, cfg):
    """The serve phase's 8 requests: prompts of SERVE_LENGTHS[:6], request
    5 repeating request 0's prompt (the prefix cache adopts it whole) and
    request 7 extending request 6's (the cache extends it); 6 greedy, 2
    sampled with fixed seeds."""
    gen = torch.Generator().manual_seed(7)

    def tokens(n):
        return torch.randint(0, cfg.vocab, (n,), generator=gen).tolist()

    base = [tokens(n) for n in SERVE_LENGTHS[:6]]
    prompts = base[:5] + [base[0], base[5],
                          base[5] + tokens(SERVE_LENGTHS[6])]
    return prompts, [0.0] * 6 + [0.8, 0.8], [None] * 6 + [11, 12]


def stream(torch, engine, prompts, temps, seeds, new_tokens=NEW_TOKENS,
           first_token_s=None):
    """Every request through ``submit_stream`` with a ``Scheduler`` thread
    answering; returns each request's events and the wall seconds.
    ``first_token_s``, a list, receives each request's seconds from the
    start to its first token."""
    from kubeflow_tpu_torch.serving import Scheduler

    events = [[] for _ in prompts]
    done = [threading.Event() for _ in prompts]
    firsts = [None] * len(prompts)

    def sink_for(i):
        def sink(event):
            if firsts[i] is None:
                firsts[i] = time.perf_counter() - started
            events[i].append(event)
            if event.get("done"):
                done[i].set()
        return sink

    torch.cuda.synchronize()
    started = time.perf_counter()
    sched = Scheduler(engine).start()
    try:
        for i, prompt in enumerate(prompts):
            engine.submit_stream(prompt, sink_for(i),
                                 max_new_tokens=new_tokens,
                                 temperature=temps[i], rng=seeds[i])
        for i, ev in enumerate(done):
            while not ev.wait(0.5):
                if (sched.failures_total
                        or time.perf_counter() - started > 900):
                    _fail(f"request {i} did not finish ({sched.failures_total}"
                          " failed scheduler cycles)")
        torch.cuda.synchronize()
    finally:
        sched.stop()
    if sched.failures_total:
        _fail("the scheduler thread reported failed cycles")
    if first_token_s is not None:
        first_token_s.extend(firsts)
    return events, time.perf_counter() - started


def check_streams(cfg, events, prompts, temps, seeds, params, **gen_kw):
    """Every request's stream is whole and in vocabulary, the prefix-cache
    pairs hit, and requests 0-6 equal ``generate`` on ``params`` (with
    ``gen_kw``); returns (outputs, cache hits)."""
    from kubeflow_tpu_torch.models.decoding import generate

    outputs = [next(e for e in ev if e.get("done"))["tokens"]
               for ev in events]
    for i, out in enumerate(outputs):
        if len(out) != NEW_TOKENS:
            _fail(f"request {i} streamed {len(out)} tokens")
        if not all(0 <= t < cfg.vocab for t in out):
            _fail(f"request {i} emitted an out-of-vocabulary token")
    hits = [next(e for e in ev if e.get("done"))["cache_hit"]
            for ev in events]
    if not (hits[5] and hits[7]):
        _fail(f"prefix-cache pairs missed the cache: {hits}")
    for i in range(7):
        ref = generate(cfg, params, [prompts[i]], NEW_TOKENS,
                       temperature=temps[i], rng=seeds[i],
                       **gen_kw)[0].tolist()
        if ref != outputs[i]:
            first = next(j for j, (a, b) in enumerate(zip(ref, outputs[i]))
                         if a != b)
            _fail(f"request {i} (temperature {temps[i]}) diverged from "
                  f"generate({gen_kw or ''}) at token {first}")
    return outputs, hits


def logits_vs_plain(torch, cfg, params, params32, tokens):
    """Prefill and first-decode logits of the kernel path (bf16 on the
    card) against the plain path in f32 on ``params32``; fails past
    TOL_LOGITS or on a non-finite logit. Returns (errors, scales)."""
    from kubeflow_tpu_torch.models.decoding import KVCache, forward_with_cache

    prompt = torch.tensor([tokens], device="cuda")
    cache = KVCache.init(cfg, 1, len(tokens) + 8)
    lk1, cache = forward_with_cache(cfg, params, prompt, cache,
                                    last_logits_only=True)
    nxt = lk1[:, -1].argmax(-1, keepdim=True)
    lk2, _ = forward_with_cache(cfg, params, nxt, cache)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    cache32 = KVCache.init(cfg32, 1, len(tokens) + 8)
    lp1, cache32 = forward_with_cache(cfg32, params32, prompt, cache32,
                                      last_logits_only=True)
    lp2, _ = forward_with_cache(cfg32, params32, nxt, cache32)
    torch.cuda.synchronize()
    errs = [max_err(lk1, lp1), max_err(lk2, lp2)]
    for err in errs:
        if not err <= TOL_LOGITS:
            _fail(f"kernel-path logits differ from the f32 plain path by "
                  f"{err} > {TOL_LOGITS}")
    if not all(torch.isfinite(t).all() for t in (lk1, lk2)):
        _fail("non-finite logits")
    return errs, [float(lp1.abs().max()), float(lp2.abs().max())]


def engine_rates(engine, cfg, prompts, outputs, launches) -> dict:
    """Prefill and decode rates of one engine run from its profiler."""
    # Prompt tokens the model actually ran: request 5 adopts request 0's
    # cached prefill whole, request 7 reuses request 6's prompt.
    prompt_tokens = sum(len(p) for p in prompts)
    computed = prompt_tokens - len(prompts[0]) - len(prompts[6])
    totals = engine.profiler.snapshot()
    prefill_s = totals.get("prefill", {}).get("total_s")
    decode_s = totals.get("decode", {}).get("total_s")
    steps = launches["qkv_rope"] // cfg.layers
    return {
        "requests": len(prompts), "tokens": sum(map(len, outputs)),
        "prompt_tokens": prompt_tokens, "prefill_tokens": computed,
        "prefill_s": prefill_s, "decode_s": decode_s,
        "prefill_tok_s": computed / prefill_s if prefill_s else None,
        "decode_tok_s": ((sum(map(len, outputs)) - len(prompts)) / decode_s
                         if decode_s else None),
        "decode_steps": steps,
        "decode_step_ms": decode_s / steps * 1e3 if steps else None,
        "cycle_profile": engine.profiler.compact(), "launches": launches,
    }


def serve_phase(torch, cfg):
    """The engine run at full width: every kernel must launch, greedy
    streams equal ``generate``, the kernel path's logits agree with the
    plain path in f32. Returns the phase line, the params and the
    requests' streamed tokens."""
    from kubeflow_tpu_torch.models.transformer import init_params, param_count
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.serving import make_engine

    params = init_params(cfg, seed=0, device="cuda", dtype=cfg.dtype)
    prompts, temps, seeds = serve_requests(torch, cfg)
    engine = make_engine(cfg, params, max_batch=8, max_len=2048)
    torch.cuda.synchronize()
    _build.reset_launches()
    events, wall = stream(torch, engine, prompts, temps, seeds)
    launches = dict(_build.LAUNCHES)
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            _fail(f"kernel {name} was never launched on the serving path")
    outputs, hits = check_streams(cfg, events, prompts, temps, seeds, params)

    # Kernel path (bf16) vs the plain path in f32, on one request's
    # prefill and first decode step.
    params32 = {key: {n: {leaf: t.float() for leaf, t in sub.items()}
                      for n, sub in val.items()}
                if key.startswith("block_")
                else {leaf: t.float() for leaf, t in val.items()}
                for key, val in params.items()}
    logit_err, logit_scale = logits_vs_plain(torch, cfg, params, params32,
                                             prompts[3])
    return {
        "phase": "serve", "params": param_count(params), "wall_s": wall,
        **engine_rates(engine, cfg, prompts, outputs, launches),
        "cache_hits": hits, "logit_max_abs_err": logit_err,
        "logit_max_abs": logit_scale, "logit_tol": TOL_LOGITS,
    }, params, outputs


def int8_phase(torch, cfg, params, requests):
    """C1 and the int8 weights at full width: an int8 KV cache whose
    layers' scale slices sit off 16-byte boundaries decodes on the card
    as on the CPU; the engine serves ``quantize_decode_params`` of the
    serve params through the int8 GEMV and the int8 fused QKV+RoPE, its
    streams equal ``generate(quantize_weights=True)``, and its logits
    agree with the f32 plain path on the dequantised weights. Returns
    the phase line and the quantised params."""
    from kubeflow_tpu_torch.models.decoding import (
        Int8Linear,
        generate,
        quantize_decode_params,
    )
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.serving import make_engine

    prompts, temps, seeds = requests
    # C1: prompt 8 + 8 new gives capacity 15 (no rounding below 256), so
    # layer i's scale slice starts at i * 1 * 2 * 15 * 4 = 120 i bytes.
    short = [prompts[0][:8]]
    card_tokens = generate(cfg, params, short, 8,
                           quantize_cache=True)[0].tolist()
    on_cpu = {key: {n: t.cpu() if isinstance(t, torch.Tensor)
                    else {leaf: x.cpu() for leaf, x in t.items()}
                    for n, t in val.items()}
              for key, val in params.items()}
    cpu_tokens = generate(cfg, on_cpu, short, 8, quantize_cache=True,
                          device="cpu")[0].tolist()
    del on_cpu
    if card_tokens != cpu_tokens:
        _fail(f"int8-cache generate at capacity 15: card {card_tokens} vs "
              f"CPU {cpu_tokens}")

    qparams = quantize_decode_params(cfg, params)
    engine = make_engine(cfg, qparams, max_batch=8, max_len=2048)
    torch.cuda.synchronize()
    _build.reset_launches()
    events, wall = stream(torch, engine, prompts, temps, seeds)
    launches = dict(_build.LAUNCHES)
    for name in ("gemv", "qkv_rope"):
        if launches[name] <= 0:
            _fail(f"kernel {name} was never launched on int8 weights")
    outputs, hits = check_streams(cfg, events, prompts, temps, seeds, params,
                                  quantize_weights=True)

    def dequantised(lin, axis):
        if not isinstance(lin, Int8Linear):
            _fail("quantize_decode_params left a float weight")
        return lin.w8.float() * lin.scale.unsqueeze(axis)

    params32 = {key: ({n: ({"kernel": dequantised(sub["kernel"], 0)}
                           if "kernel" in sub
                           else {k: t.float() for k, t in sub.items()})
                       for n, sub in val.items()}
                      if key.startswith("block_")
                      else {"embedding": dequantised(val["embedding"], 1)}
                      if key == "embed"
                      else {k: t.float() for k, t in val.items()})
                for key, val in qparams.items()}
    logit_err, logit_scale = logits_vs_plain(torch, cfg, qparams, params32,
                                             prompts[3])
    return {
        "phase": "int8", "c1_capacity": 15, "c1_tokens": card_tokens,
        "wall_s": wall, **engine_rates(engine, cfg, prompts, outputs,
                                       launches),
        "cache_hits": hits, "logit_max_abs_err": logit_err,
        "logit_max_abs": logit_scale, "logit_tol": TOL_LOGITS,
    }, qparams


def sse_request(url: str, body: dict) -> dict:
    """One ``POST /v1/generate`` over a fresh connection, its SSE frames
    parsed and each token's arrival timed on the client's clock."""
    import http.client
    import urllib.parse

    parts = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=GATEWAY_TIMEOUT_S)
    sent = time.perf_counter()
    try:
        conn.request("POST", "/v1/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        response = conn.getresponse()
        if response.status != 200:
            _fail(f"/v1/generate answered {response.status}")
        if response.getheader("Content-Type") != "text/event-stream":
            _fail("/v1/generate did not answer with an event stream")
        tokens, arrivals, done, event = [], [], None, None
        for raw in response:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                frame = json.loads(line[len("data: "):])
                if event == "done":
                    done = frame
                    break
                if frame.get("index") != len(tokens):
                    _fail(f"SSE frame out of order: {frame}")
                tokens.append(frame["token"])
                arrivals.append(time.perf_counter())
            elif line:
                _fail(f"unexpected SSE line {line!r}")
            else:
                event = None
        finished = time.perf_counter()
    finally:
        conn.close()
    if done is None or done["tokens"] != tokens:
        _fail(f"the stream ended without a done frame matching its tokens "
              f"({done})")
    return {"tokens": tokens, "done": done, "sent": sent,
            "arrivals": arrivals, "finished": finished}


def http_json(url: str, path: str, body=None) -> tuple[int, dict]:
    """GET (or POST ``body``) and return (status, decoded JSON)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=GATEWAY_TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def percentile(values, q: float) -> float:
    """Nearest-rank percentile."""
    ranked = sorted(values)
    return ranked[min(len(ranked) - 1, max(0, math.ceil(q * len(ranked)) - 1))]


def gateway_phase(torch, cfg, params, requests, outputs):
    """The serve requests over HTTP: a fresh engine at full width behind
    ``InferenceGateway``, the 8 requests sent at once from 8 client
    threads; every SSE frame parses and every stream equals the serve
    phase's; then ``stream: false``, a 400, the health routes and
    ``/metrics`` read back with the port's own parser; then the pod
    entrypoint as its own process."""
    import urllib.request

    from kubeflow_tpu_torch.obs.exposition import parse_text, sample_value
    from kubeflow_tpu_torch.serving import InferenceGateway, make_engine

    prompts, temps, seeds = requests
    engine = make_engine(cfg, params, max_batch=8, max_len=2048)
    gateway = InferenceGateway(engine, port=0).start()
    url = f"http://127.0.0.1:{gateway.port}"
    try:
        results = [None] * len(prompts)
        errors = []

        def client(i):
            body = {"prompt": prompts[i], "max_new_tokens": NEW_TOKENS}
            if temps[i] > 0:
                body.update(temperature=temps[i], seed=seeds[i])
            try:
                results[i] = sse_request(url, body)
            except Exception as exc:  # analysis: allow[py-broad-except]
                # Kept and re-raised on the main thread below.
                errors.append((i, exc))

        torch.cuda.synchronize()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        started = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(GATEWAY_TIMEOUT_S)
            if t.is_alive():
                _fail("an HTTP client did not finish")
        wall = time.perf_counter() - started
        if errors:
            raise errors[0][1]
        for i, res in enumerate(results):
            if res["tokens"] != outputs[i]:
                _fail(f"HTTP stream {i} (temperature {temps[i]}) differs "
                      "from the serve phase's stream")
            if res["done"]["reason"] != "length":
                _fail(f"HTTP stream {i} ended with {res['done']['reason']}")

        status, payload = http_json(url, "/v1/generate", {
            "prompt": prompts[3], "max_new_tokens": NEW_TOKENS,
            "stream": False})
        if status != 200 or payload["tokens"] != outputs[3]:
            _fail(f"stream: false answered {status} with other tokens")
        status, payload = http_json(url, "/v1/generate", {"prompt": []})
        if status != 400 or "prompt" not in payload.get("error", ""):
            _fail(f"an empty prompt answered {status} {payload}")
        for path, want in (("/healthz", {"status": "ok"}),
                           ("/readyz", {"ready": True})):
            if http_json(url, path) != (200, want):
                _fail(f"{path} did not answer 200 {want}")
        with urllib.request.urlopen(url + "/metrics",
                                    timeout=GATEWAY_TIMEOUT_S) as r:
            families = parse_text(r.read().decode())
        served = len(prompts) + 1
        server = {}
        for name in ("inference_ttft_seconds", "inference_itl_seconds"):
            server[name] = {
                "count": sample_value(families, f"{name}_count"),
                "sum": sample_value(families, f"{name}_sum")}
        server["inference_request_duration_seconds"] = {
            outcome: {"count": sample_value(
                families, "inference_request_duration_seconds_count",
                {"outcome": outcome}), "sum": sample_value(
                families, "inference_request_duration_seconds_sum",
                {"outcome": outcome})}
            for outcome in ("ok", "bad_request")}
        if server["inference_ttft_seconds"]["count"] != served:
            _fail(f"inference_ttft_seconds counted "
                  f"{server['inference_ttft_seconds']['count']} of "
                  f"{served} requests")
    finally:
        gateway.stop()

    ttft = [r["arrivals"][0] - r["sent"] for r in results]
    gaps = [b - a for r in results
            for a, b in zip(r["arrivals"], r["arrivals"][1:])]
    return {
        "phase": "gateway", "requests": len(prompts), "wall_s": wall,
        "ttft_s": {"min": min(ttft), "median": statistics.median(ttft),
                   "max": max(ttft), "each": ttft},
        "itl_s": {"median": statistics.median(gaps),
                  "p99": percentile(gaps, 0.99), "max": max(gaps),
                  "count": len(gaps)},
        "request_wall_s": [r["finished"] - r["sent"] for r in results],
        "server": server,
        "pod": pod_check(cfg, prompts[3], outputs[3]),
    }


def pod_check(cfg, prompt, want) -> dict:
    """``python -m kubeflow_tpu_torch.serving`` as its own process at the
    flagship's dims on a free port: ready within POD_READY_TIMEOUT_S, one
    greedy request equal to ``want`` (the serve phase's stream of the
    same prompt on the same seeded init), exit 0 on SIGTERM."""
    import os
    import signal
    import socket
    from pathlib import Path

    from kubeflow_tpu_torch.ops import _build

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dims = {"vocab": cfg.vocab, "layers": cfg.layers, "dim": cfg.dim,
            "heads": cfg.heads, "kv_heads": cfg.kv_heads,
            "dtype": str(cfg.dtype).removeprefix("torch.")}
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KFT_SERVING_")}
    env.update(KFT_SERVING_CONFIG=json.dumps(dims),
               KFT_SERVING_PORT=str(port))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log_path = _build.BUILD_DIR / "pod.log"
    url = f"http://127.0.0.1:{port}"
    started = time.perf_counter()
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.serving"],
            cwd=Path(__file__).resolve().parent, env=env, stdout=log,
            stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    _fail(f"the pod exited with {proc.returncode} before "
                          f"it was ready: {log_path.read_text()[-2000:]}")
                try:
                    if http_json(url, "/readyz") == (200, {"ready": True}):
                        break
                except OSError:
                    pass
                if time.perf_counter() - started > POD_READY_TIMEOUT_S:
                    _fail(f"the pod was not ready within "
                          f"{POD_READY_TIMEOUT_S} s")
                time.sleep(0.5)
            ready_s = time.perf_counter() - started
            t0 = time.perf_counter()
            reply = sse_request(url, {"prompt": prompt,
                                      "max_new_tokens": len(want)})
            request_s = time.perf_counter() - t0
            if reply["tokens"] != want:
                _fail("the pod's greedy stream differs from generate()")
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=120)
            if code != 0:
                _fail(f"the pod exited with {code} on SIGTERM: "
                      f"{log_path.read_text()[-2000:]}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    return {"ready_s": ready_s, "request_s": request_s,
            "ttft_s": reply["arrivals"][0] - reply["sent"],
            "exit_code": code}


# ---------------------------------------------------------------- trace

PORT_KERNELS = {"flash_fwd_kernel": "flash_attention",
                "flash_dq_kernel": "flash_dq",
                "flash_dkv_kernel": "flash_dkv",
                "gemv_kn_kernel": "gemv", "gemv_nk_kernel": "gemv",
                "qkv_rope_kernel": "qkv_rope",
                "decode_attention_kernel": "decode_attention"}


def kernel_group(name: str) -> str:
    """A device event's name, short: the port's kernels by their wrapper,
    anything else cut before its template or argument list."""
    for symbol, wrapper in PORT_KERNELS.items():
        if symbol in name:
            return wrapper
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0][:60] or "(unnamed)"


def trace_phase(torch, cfg, params):
    """The serve requests again, on a fresh engine, under torch.profiler:
    device time per kernel and the device's idle share between its first
    and last event. The profiler adds host cost per launch, so the idle
    share read here is an upper bound for the untraced run."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.serving import make_engine

    engine = make_engine(cfg, params, max_batch=8, max_len=2048)
    requests = serve_requests(torch, cfg)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = stream(torch, engine, *requests)
    return {"phase": "trace", "wall_s": wall, **device_breakdown(prof)}


def device_breakdown(prof, top_n: int = 16) -> dict:
    """Device events of a profiler run: busy time (the union of their
    intervals) and idle share between the first and last, and time per
    kernel group, largest first."""
    from torch.autograd import DeviceType

    spans, groups = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        start, dur = ev.start_ns(), ev.duration_ns()
        spans.append((start, start + dur))
        count, ns = groups.get(kernel_group(ev.name()), (0, 0))
        groups[kernel_group(ev.name())] = (count + 1, ns + dur)
    if not spans:
        _fail("the profiler recorded no device activity")
    spans.sort()
    busy, reach = 0, spans[0][0]
    for start, end in spans:   # union of the device intervals
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    window = reach - spans[0][0]
    top = sorted(groups.items(), key=lambda kv: -kv[1][1])
    return {"device_events": len(spans), "device_window_ms": window / 1e6,
            "device_busy_ms": busy / 1e6, "idle_share": 1.0 - busy / window,
            "groups": [{"name": n, "count": c, "ms": ns / 1e6}
                       for n, (c, ns) in top[:top_n]]}


# ---------------------------------------------------------------- train


def train_config(torch):
    """bench.py's LM (``_lm_dims``: vocab 32768, 8 layers, dim 1024,
    8 heads, full MHA) with bf16 compute."""
    from kubeflow_tpu_torch.models import LMConfig

    return LMConfig(vocab=32768, layers=8, dim=1024, heads=8,
                    dtype=torch.bfloat16)


def rounded_delta_attention(torch, round_o: bool):
    """The plain path's causal MHA (f32 softmax) with a hand-written
    backward that is exact in f32 except for delta = rowsum(dO * O): with
    ``round_o`` it takes O rounded to bf16, as the flash backward does
    (the reference's scheme), else the f32 O, as autograd of the plain
    path does. The pair isolates that one rounding in the step-0
    comparison."""

    class Attention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            scale = q.shape[-1] ** -0.5
            s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
            n = s.shape[-1]
            live = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
            w = torch.softmax(s.masked_fill(~live, float("-inf")), dim=-1)
            o = torch.einsum("bhqk,bhkd->bhqd", w, v.float())
            ctx.save_for_backward(q, k, v, w,
                                  o.to(torch.bfloat16) if round_o else o)
            return o.to(q.dtype)

        @staticmethod
        def backward(ctx, g):
            q, k, v, w, o = ctx.saved_tensors
            scale = q.shape[-1] ** -0.5
            do = g.float()
            delta = (do * o.float()).sum(-1, keepdim=True)
            dp = torch.einsum("bhqd,bhkd->bhqk", do, v.float())
            ds = w * (dp - delta) * scale
            dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
            dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
            dv = torch.einsum("bhqk,bhqd->bhkd", w, do)
            return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

    def core(q, k, v, causal=True, segment_ids=None):
        if not causal or segment_ids is not None or k.shape[1] != q.shape[1]:
            _fail("the rounded-delta core takes causal MHA only")
        return Attention.apply(q, k, v)

    return core


def twin_attention(torch):
    """The kernels' plain twins as a causal attention core: the forward
    with lse, delta from the bf16 O, dq and dk/dv, every rounding point
    of the kernel path, no kernel."""
    from kubeflow_tpu_torch.ops.attention import (
        flash_dkv_reference,
        flash_dq_reference,
        flash_forward_reference,
    )

    class Attention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = flash_forward_reference(q, k, v, causal=True)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, g):
            q, k, v, o, lse = ctx.saved_tensors
            delta = (g.float() * o.float()).sum(-1)
            args = (q, k, v, g.contiguous(), lse, delta)
            dq = flash_dq_reference(*args, causal=True)
            dk, dv = flash_dkv_reference(*args, causal=True)
            return dq, dk, dv

    def core(q, k, v, causal=True, segment_ids=None):
        if not causal or segment_ids is not None:
            _fail("the twin core takes causal attention only")
        return Attention.apply(q, k, v)

    return core


def train_setup(torch):
    """The train configuration's state (f32 parameters from seed 0) and
    its one fixed token batch."""
    from kubeflow_tpu_torch.models import build_lm, create_lm_state

    cfg = train_config(torch)
    state = create_lm_state(build_lm(cfg), seed=0)
    gen = torch.Generator(device="cuda").manual_seed(2024)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                           device="cuda", generator=gen)
    return cfg, state, tokens


@contextlib.contextmanager
def widened_products(torch):
    """The LM's dense products and tied head as the widened f32
    expressions they run off the card (bf16 operands widened, multiplied
    in f32, the dense results rounded once): the plain path's products,
    independent of the tensor-core path the card takes."""
    from kubeflow_tpu_torch.models import transformer

    def dense(h, kernel, dtype):
        return (h.to(dtype).float() @ kernel.to(dtype).float()).to(dtype)

    def head(x, embedding, dtype):
        return torch.einsum("bsd,vd->bsv", x.to(dtype).float(),
                            embedding.to(dtype).float())

    real = transformer._dense, transformer.tied_head
    transformer._dense, transformer.tied_head = dense, head
    try:
        yield
    finally:
        transformer._dense, transformer.tied_head = real


def step0_readings(torch, cfg, state, tokens) -> dict:
    """Step-0 loss and gradients through five attention cores, compared
    leaf by leaf in relative norm: the kernels and their plain twins
    against the plain path (``build_lm(use_flash=False)``) and against
    each other; the plain core with delta from a bf16 O, and with delta
    from the f32 O (a control: summation order only), against the plain
    path. Every core but the kernel path's takes ``widened_products``;
    the kernel path takes the card's tensor-core products, and so does
    ``products``, the plain path's attention with them, read against the
    plain path. Checks nothing: ``train_phase`` checks the kernel path's
    and the products' readings against the plain path, and a run with a
    planted fault reads them."""
    from kubeflow_tpu_torch.models import TransformerLM, build_lm, lm_loss
    from kubeflow_tpu_torch.models.optim import flatten

    paths = [path for path, _ in flatten(state.params)]
    leaves = [p for _, p in flatten(state.params)]

    def loss_and_grads(model):
        loss = lm_loss(model(state.params, tokens), tokens)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), grads

    cores = {
        "plain": build_lm(cfg, use_flash=False),
        "kernel": build_lm(cfg, use_flash=True),
        "products": build_lm(cfg, use_flash=False),
        "twins": TransformerLM(cfg, twin_attention(torch)),
        "bf16_delta": TransformerLM(cfg, rounded_delta_attention(torch, True)),
        "f32_delta": TransformerLM(cfg, rounded_delta_attention(torch, False)),
    }
    losses, grads = {}, {}
    for name, model in cores.items():
        products = (contextlib.nullcontext() if name in ("kernel", "products")
                    else widened_products(torch))
        with products:
            losses[name], grads[name] = loss_and_grads(model)
    pairs = {"kernel_vs_plain": ("kernel", "plain"),
             "products_vs_plain": ("products", "plain"),
             "twins_vs_plain": ("twins", "plain"),
             "kernel_vs_twins": ("kernel", "twins"),
             "bf16_delta_vs_plain": ("bf16_delta", "plain"),
             "f32_delta_vs_plain": ("f32_delta", "plain")}
    per_leaf = {
        pair: {path: float((g - r).norm() / r.norm())
               for path, g, r in zip(paths, grads[a], grads[b])}
        for pair, (a, b) in pairs.items()}
    worst = {pair: max(errs.items(), key=lambda kv: kv[1])
             for pair, errs in per_leaf.items()}
    return {"loss": losses, "worst": worst, "per_leaf": per_leaf}


def train_phase(torch):
    """Step-0 loss and gradients, kernel path vs plain path; then
    TRAIN_STEPS steps on one fixed batch with the launch counters zeroed
    just before and read just after; then one step under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models import make_lm_train_step
    from kubeflow_tpu_torch.models.transformer import (
        TENSOR_CORE_PRODUCTS,
        param_count,
    )
    from kubeflow_tpu_torch.ops import _build

    cfg, state, tokens = train_setup(torch)
    batch = {"tokens": tokens}
    step0 = step0_readings(torch, cfg, state, tokens)
    plain_loss = step0["loss"]["plain"]
    for core in ("kernel", "products"):
        loss = step0["loss"][core]
        worst, err = step0["worst"][f"{core}_vs_plain"]
        if not abs(loss - plain_loss) <= TRAIN_LOSS_TOL:
            _fail(f"step-0 loss {loss} of the {core} path differs from the "
                  f"plain path's {plain_loss} by more than {TRAIN_LOSS_TOL}")
        if not err <= TRAIN_GRAD_TOL:
            _fail(f"step-0 gradient of {worst} of the {core} path is {err} "
                  f"from the plain path's in relative norm (limit "
                  f"{TRAIN_GRAD_TOL})")
    worst, err = step0["worst"]["kernel_vs_plain"]

    step = make_lm_train_step(cfg=cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    products0 = dict(TENSOR_CORE_PRODUCTS)
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))   # syncs the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.LAUNCHES)
    products = {name: TENSOR_CORE_PRODUCTS[name] - products0[name]
                for name in products0}
    peak = torch.cuda.max_memory_allocated()
    for name in TRAIN_KERNELS:
        if launches[name] != TRAIN_STEPS * cfg.layers:
            _fail(f"{name} launched {launches[name]} times in "
                  f"{TRAIN_STEPS} steps, not {cfg.layers} per step")
    for name in STEP_KERNELS:
        if launches[name] != TRAIN_STEPS:
            _fail(f"{name} launched {launches[name]} times in "
                  f"{TRAIN_STEPS} steps, not once a step")
    want = {"dense_mm": 6 * cfg.layers * TRAIN_STEPS,
            "head_mm": TRAIN_STEPS}
    if products != want:
        _fail(f"tensor-core products in {TRAIN_STEPS} steps: {products}, "
              f"not {want}")
    if not all(math.isfinite(x) for x in losses):
        _fail(f"non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        _fail(f"the loss did not fall on a fixed batch: {losses}")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        traced_ms = (time.perf_counter() - t0) * 1e3
    steady = statistics.median(step_ms[1:])
    return {
        "phase": "train", "params": param_count(state.params),
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "losses": losses, "step_ms": step_ms, "step_ms_median": steady,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady * 1e3,
        "max_memory_allocated": peak, "launches": launches,
        "launches_per_step": {n: launches[n] / TRAIN_STEPS
                              for n in TRAIN_KERNELS + STEP_KERNELS},
        "tensor_core_products": products,
        "step0_loss": step0["loss"], "step0_grad_rel_err_max": err,
        "step0_grad_rel_err_worst_leaf": worst,
        "step0_grad_worst": step0["worst"],
        "step0_grad_rel_err": step0["per_leaf"]["kernel_vs_plain"],
        "grad_tol": TRAIN_GRAD_TOL,
        "traced_step": {"step_ms": traced_ms, **device_breakdown(prof)},
    }


# ---------------------------------------------------------- checkpoint

# ckpt phase: the train config trained by ``run_with_checkpointing`` on a
# seeded stream of CKPT_STEPS distinct batches; saves every
# CKPT_SAVE_EVERY steps (in the background), CKPT_KEEP kept; run B is
# preempted by SIGTERM while step CKPT_PREEMPT_AT is in flight.
CKPT_STEPS, CKPT_SAVE_EVERY, CKPT_KEEP, CKPT_PREEMPT_AT = 8, 2, 2, 3
# The resumed run's losses against the uninterrupted run's, relative.
CKPT_LOSS_RTOL = 1e-4
# pod_ckpt: the greedy request's prompt length and new tokens.
POD_PROMPT, POD_NEW_TOKENS = 256, 32


class TimedStep:
    """The train step with its loss and host-synced milliseconds kept
    per step, and whether a background save was in flight when the step
    began (``manager`` is the run's CheckpointManager)."""

    def __init__(self, torch, step, manager, losses, times):
        self.torch, self.step, self.manager = torch, step, manager
        self.losses, self.times = losses, times

    def __call__(self, state, batch):
        inflight = self.manager._inflight is not None and \
            self.manager._inflight.is_alive()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = self.step(state, batch)
        loss = float(metrics["loss"])   # syncs the step
        self.times.append({"step": state.step, "in_flight": inflight,
                           "ms": (time.perf_counter() - t0) * 1e3})
        self.losses[state.step] = loss
        return state, metrics


def state_leaves(state) -> dict:
    from kubeflow_tpu_torch.models.checkpoint import (
        _arrays_only,
        _flatten_keys,
    )

    return dict(_flatten_keys(_arrays_only(state)))


def states_equal(torch, a, b) -> bool:
    """Leaf by leaf, bit for bit (``torch.equal``; the int32 step and
    count as numbers)."""
    la, lb = state_leaves(a), state_leaves(b)
    if la.keys() != lb.keys():
        return False
    return all(torch.equal(x, lb[k]) if isinstance(x, torch.Tensor)
               else int(x) == int(lb[k]) for k, x in la.items())


def flip_byte(path, offset: int) -> None:
    with open(path, "r+b") as fh:
        fh.seek(offset)
        byte = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([byte[0] ^ 0xFF]))


def ckpt_phase(torch, root):
    """Runs A (uninterrupted), B (preempted) and C (resumed from B) of
    ``run_with_checkpointing`` at the train config under ``root``, with
    the launch counters zeroed just before A and read just after C; then
    a corrupt-newest-step fallback, and a save and restore timed alone.
    Returns the phase line and C's directory."""
    import os
    import signal
    import tempfile

    from kubeflow_tpu_torch.models import (
        build_lm,
        create_lm_state,
        make_lm_train_step,
        realign_batches,
        run_with_checkpointing,
    )
    from kubeflow_tpu_torch.models.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.ops import _build

    cfg = train_config(torch)
    gen = torch.Generator(device="cuda").manual_seed(2025)
    batches = [{"tokens": torch.randint(0, cfg.vocab,
                                        (TRAIN_BATCH, TRAIN_SEQ),
                                        device="cuda", generator=gen)}
               for _ in range(CKPT_STEPS)]
    step = make_lm_train_step(cfg=cfg)
    losses = {"A": {}, "B": {}, "C": {}}
    times = []

    def fresh(seed):
        return create_lm_state(build_lm(cfg), seed=seed)

    def run(name, directory, state, stream, **kw):
        mgr = CheckpointManager(directory, keep=CKPT_KEEP)
        state, report = run_with_checkpointing(
            TimedStep(torch, step, mgr, losses[name], times), state, stream,
            mgr, save_every_steps=CKPT_SAVE_EVERY, **kw)
        return state, report, mgr

    dirs = {name: tempfile.mkdtemp(prefix=f"ckpt_{name}_", dir=root)
            for name in ("A", "B", "M")}
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    state_a, rep_a, mgr_a = run("A", dirs["A"], fresh(0), batches,
                                install_signal_handler=False)
    wall_a = time.perf_counter() - t0
    if rep_a.final_step != CKPT_STEPS or mgr_a.steps() != [6, 8]:
        _fail(f"run A ended at {rep_a.final_step} with steps {mgr_a.steps()}")

    def preempting(stream):
        for i, batch in enumerate(stream):
            if i == CKPT_PREEMPT_AT - 1:   # step CKPT_PREEMPT_AT in flight
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    previous = signal.getsignal(signal.SIGTERM)
    state_b, rep_b, mgr_b = run("B", dirs["B"], fresh(0),
                                preempting(batches))
    if signal.getsignal(signal.SIGTERM) != previous:
        _fail("run_with_checkpointing left its SIGTERM handler installed")
    if not (rep_b.preempted and rep_b.final_step == CKPT_PREEMPT_AT
            and mgr_b.latest_committed_step() == CKPT_PREEMPT_AT):
        _fail(f"run B: preempted={rep_b.preempted} at {rep_b.final_step}, "
              f"committed {mgr_b.steps()}")

    # Run C: a fresh state (another seed) resumes from B's directory.
    # Its first step checks the restored state against B's, bit for bit.
    mgr_c = CheckpointManager(dirs["B"], keep=CKPT_KEEP)
    seen = {}
    timed_c = TimedStep(torch, step, mgr_c, losses["C"], times)

    def first_checked(state, batch):
        if not seen:
            seen["equal"] = states_equal(torch, state, state_b)
            seen["step"] = state.step
        return timed_c(state, batch)

    def resumed():
        yield from realign_batches(batches, mgr_c.last_restore["step"])

    t0 = time.perf_counter()
    state_c, rep_c = run_with_checkpointing(
        first_checked, fresh(1), resumed(), mgr_c,
        save_every_steps=CKPT_SAVE_EVERY, install_signal_handler=False)
    wall_c = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    total_steps = CKPT_STEPS + CKPT_PREEMPT_AT + (CKPT_STEPS
                                                  - CKPT_PREEMPT_AT)
    for name in TRAIN_KERNELS:
        if launches[name] != total_steps * cfg.layers:
            _fail(f"{name} launched {launches[name]} times in the ckpt "
                  f"runs' {total_steps} steps, not {cfg.layers} per step")
    if rep_c.resumed_from_step != CKPT_PREEMPT_AT or \
            rep_c.final_step != CKPT_STEPS:
        _fail(f"run C resumed from {rep_c.resumed_from_step} and ended at "
              f"{rep_c.final_step}")
    if not seen.get("equal") or seen.get("step") != CKPT_PREEMPT_AT:
        _fail("the state restored at run C's start is not B's saved state")
    resumed_steps = range(CKPT_PREEMPT_AT + 1, CKPT_STEPS + 1)
    rel = {i: abs(losses["C"][i] - losses["A"][i]) / abs(losses["A"][i])
           for i in resumed_steps}
    if not all(math.isfinite(losses["A"][i]) for i in losses["A"]):
        _fail(f"non-finite losses in run A: {losses['A']}")
    if not max(rel.values()) <= CKPT_LOSS_RTOL:
        _fail(f"resumed losses differ from the uninterrupted run's: {rel}")
    bit_equal = all(losses["C"][i] == losses["A"][i] for i in resumed_steps)

    # A byte flipped inside the newest step's shard: the restore falls
    # back to the step before it.
    shard = os.path.join(dirs["A"], str(CKPT_STEPS), "shard-00000.bin")
    ckpt_bytes = os.path.getsize(shard)
    flip_byte(shard, ckpt_bytes // 2)
    mgr_f = CheckpointManager(dirs["A"], keep=CKPT_KEEP)
    fallback = mgr_f.restore_latest_valid(state_a)
    if fallback is None or fallback[1] != CKPT_STEPS - CKPT_SAVE_EVERY or \
            mgr_f.metrics.restore_total.get("skipped_corrupt") != 1:
        _fail(f"a corrupt step {CKPT_STEPS} did not fall back to step "
              f"{CKPT_STEPS - CKPT_SAVE_EVERY}: {mgr_f.metrics.restore_total}")
    del fallback

    # A save and a restore alone: save_async's blocking part is the
    # snapshot (nothing in flight before it), wait() the durable write.
    mgr_m = CheckpointManager(dirs["M"], keep=1)
    saves = []
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr_m.save_async(100 + rep, state_a)
        blocking = time.perf_counter() - t0
        mgr_m.wait()
        total = time.perf_counter() - t0
        saves.append({"blocking_ms": blocking * 1e3, "save_s": total,
                      "gb_per_s": ckpt_bytes / total / 1e9})
    # The commit's share of a save: one streamed sha256 over the
    # committed shard file (the manifest's file digest).
    from kubeflow_tpu_torch.models.checkpoint import _sha256_file

    t0 = time.perf_counter()
    _sha256_file(os.path.join(dirs["M"], "101", "shard-00000.bin"))
    file_hash_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = mgr_m.restore_latest_valid(state_a)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if restored is None or not states_equal(torch, restored[0], state_a):
        _fail("a timed save did not restore to the state it saved")
    del restored, state_a, state_b, state_c
    import shutil

    for name in ("A", "M"):
        shutil.rmtree(dirs[name], ignore_errors=True)

    plain = [t["ms"] for t in times if not t["in_flight"]]
    busy = [t["ms"] for t in times if t["in_flight"]]
    line = {
        "phase": "ckpt", "steps": CKPT_STEPS,
        "save_every_steps": CKPT_SAVE_EVERY, "keep": CKPT_KEEP,
        "ckpt_bytes": ckpt_bytes,
        "losses": {k: [v[i] for i in sorted(v)] for k, v in losses.items()},
        "resumed_loss_rel_err": rel, "resumed_losses_bit_equal": bit_equal,
        "restored_state_bit_equal": seen["equal"],
        "saves": {"A": rep_a.saves, "B": rep_b.saves, "C": rep_c.saves},
        "wall_s": {"A": wall_a, "C": wall_c},
        "timed_saves": saves, "file_hash_s": file_hash_s,
        "restore_s": restore_s,
        "corrupt_fallback_step": CKPT_STEPS - CKPT_SAVE_EVERY,
        "step_ms_no_save_in_flight": {
            "median": statistics.median(plain), "n": len(plain)},
        "step_ms_save_in_flight": {
            "median": statistics.median(busy) if busy else None,
            "n": len(busy)},
        "step_ms": times, "launches": launches,
    }
    return line, dirs["B"]


def pod_ckpt_check(torch, directory) -> dict:
    """The pod entrypoint serving the train config from ``directory`` (run
    C's checkpoints): ready, one greedy request equal to ``generate`` on
    ``restore_latest_valid({"params": template})``'s params; then a newer
    step is committed (the parameters of another seed, so that the
    request's tokens change), ``POST /v1/admin/swap`` answers 200 with
    it, ``inference_model_swap_total`` reads 1, and the same request
    equals ``generate`` on the new step; exit 0 on SIGTERM. The launch
    counts are the pod's own, from the record it logs at exit: every
    serving kernel must have launched in the pod."""
    import os
    import signal
    import socket
    import urllib.request
    from pathlib import Path

    from kubeflow_tpu_torch.models import build_lm, create_lm_state
    from kubeflow_tpu_torch.models.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.models.decoding import generate
    from kubeflow_tpu_torch.obs.exposition import parse_text, sample_value
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.serving.__main__ import build_model

    cfg = train_config(torch)
    dims = {"vocab": cfg.vocab, "layers": cfg.layers, "dim": cfg.dim,
            "heads": cfg.heads, "kv_heads": cfg.kv_heads,
            "dtype": "bfloat16"}
    env_model = {"KFT_SERVING_CONFIG": json.dumps(dims)}
    serve_cfg, template = build_model(env_model)
    gen = torch.Generator().manual_seed(99)
    prompt = torch.randint(0, cfg.vocab, (POD_PROMPT,), generator=gen).tolist()

    def expected():
        mgr = CheckpointManager(directory)
        restored, got_step = mgr.restore_latest_valid({"params": template})
        tokens = generate(serve_cfg, restored["params"], [prompt],
                          POD_NEW_TOKENS)[0].tolist()
        return tokens, got_step

    want1, step1 = expected()

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KFT_SERVING_")}
    env.update(env_model, KFT_SERVING_PORT=str(port),
               KFT_SERVING_MODEL_DIR=directory)
    log_path = _build.BUILD_DIR / "pod_ckpt.log"
    url = f"http://127.0.0.1:{port}"
    started = time.perf_counter()
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.serving"],
            cwd=Path(__file__).resolve().parent, env=env, stdout=log,
            stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    _fail(f"the pod exited with {proc.returncode} before "
                          f"it was ready: {log_path.read_text()[-2000:]}")
                try:
                    if http_json(url, "/readyz") == (200, {"ready": True}):
                        break
                except OSError:
                    pass
                if time.perf_counter() - started > POD_READY_TIMEOUT_S:
                    _fail(f"the pod was not ready within "
                          f"{POD_READY_TIMEOUT_S} s")
                time.sleep(0.5)
            ready_s = time.perf_counter() - started
            reply = sse_request(url, {"prompt": prompt,
                                      "max_new_tokens": POD_NEW_TOKENS})
            if reply["tokens"] != want1:
                _fail(f"the pod's stream from checkpoint step {step1} "
                      "differs from generate() on the restored params")

            # A newer step, committed into the served directory.
            newer = create_lm_state(build_lm(cfg), seed=2)
            newer.step = step1 + 1
            CheckpointManager(directory, keep=CKPT_KEEP).save(newer.step,
                                                             newer)
            del newer
            want2, step2 = expected()
            if want2 == want1:
                _fail("the newer step's greedy tokens equal the served "
                      "step's: the swap check would prove nothing")
            t0 = time.perf_counter()
            status, payload = http_json(url, "/v1/admin/swap", {})
            if status != 200 or payload.get("info", {}).get("step") != step2:
                _fail(f"/v1/admin/swap answered {status} {payload}, not "
                      f"200 with step {step2}")
            while http_json(url, "/v1/status")[1].get("swaps", 0) < 1:
                if time.perf_counter() - t0 > GATEWAY_TIMEOUT_S:
                    _fail("the staged swap was never applied")
                time.sleep(0.1)
            swap_s = time.perf_counter() - t0
            with urllib.request.urlopen(url + "/metrics",
                                        timeout=GATEWAY_TIMEOUT_S) as r:
                swaps = sample_value(parse_text(r.read().decode()),
                                     "inference_model_swap_total")
            if swaps != 1:
                _fail(f"inference_model_swap_total reads {swaps}, not 1")
            reply2 = sse_request(url, {"prompt": prompt,
                                       "max_new_tokens": POD_NEW_TOKENS})
            if reply2["tokens"] != want2:
                _fail(f"after the swap to step {step2} the pod's stream "
                      "differs from generate() on that step's params")
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=120)
            if code != 0:
                _fail(f"the pod exited with {code} on SIGTERM: "
                      f"{log_path.read_text()[-2000:]}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    records = [json.loads(line) for line in log_path.read_text().splitlines()
               if line.startswith("{")]
    restore_s = next((r["restore_s"] for r in records if "restore_s" in r),
                     None)
    if restore_s is None:
        _fail("the pod did not log the checkpoint step it serves")
    launches = next((r["kernel_launches"] for r in records
                     if "kernel_launches" in r), None)
    if launches is None:
        _fail("the pod did not log its kernel launches at exit")
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            _fail(f"kernel {name} was never launched by the pod serving "
                  "the checkpoint")
    return {"phase": "pod_ckpt", "served_step": step1, "swapped_step": step2,
            "ready_s": ready_s, "restore_s": restore_s,
            "ttft_s": reply["arrivals"][0] - reply["sent"],
            "swap_s": swap_s, "exit_code": code, "launches": launches,
            "prompt": POD_PROMPT, "new_tokens": POD_NEW_TOKENS}


# ----------------------------------------------------------------- long

# long phase: bench.py's long mode (bench.py:749-840) on the train config
# at batch 1: (name, sequence, window, steps).
LONG_BATCH = 1
LONG_SEQ = 8192
LONG_RUNS = (("s8192", 8192, None, 4), ("s32768", 32768, None, 2),
             ("window1024", 8192, 1024, 2))
# Step 0 at S=8192, fused loss against dense loss: the losses, relative.
# Both take the same f32-accumulated logits of the same bf16 hidden
# states; they differ in the order of the logsumexp's sums.
LONG_LOSS_RTOL = 1e-3


class RecordingAdamW:
    """The train config's AdamW, keeping a host copy of the gradients it
    is given: what a step computed, read after the step."""

    def __init__(self, torch):
        from kubeflow_tpu_torch.models import AdamW

        self.inner = AdamW(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
        self.grads = None

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        self.grads = [g.detach().float().cpu() for g in grads]
        self.inner.update(grads, state, params)


def long_step0(torch, cfg, tokens) -> tuple:
    """Step 0 at S=8192 with the dense loss, then with ``"auto"`` (fused),
    each from a fresh seed-0 state with nothing else of the phase on the
    card. Returns the fused state and the comparison."""
    from kubeflow_tpu_torch.models import (
        build_lm,
        create_lm_state,
        make_lm_train_step,
    )
    from kubeflow_tpu_torch.models.optim import flatten

    out = {}
    for impl in ("dense", "auto"):
        tx = RecordingAdamW(torch)
        state = create_lm_state(build_lm(cfg), seed=0, tx=tx)
        step = make_lm_train_step(cfg=dataclasses.replace(cfg,
                                                          loss_impl=impl))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, {"tokens": tokens})
        loss = float(metrics["loss"])   # syncs the step
        ms = (time.perf_counter() - t0) * 1e3
        out[impl] = {"loss": loss, "ms": ms, "grads": tx.grads,
                     "peak": torch.cuda.max_memory_allocated()}
        if impl == "dense":
            del state, step, metrics
            torch.cuda.empty_cache()
    paths = [path for path, _ in flatten(state.params)]
    rel = {path: float((f - d).norm() / d.norm()) for path, f, d in zip(
        paths, out["auto"]["grads"], out["dense"]["grads"])}
    worst = max(rel.items(), key=lambda kv: kv[1])
    fused, dense = out["auto"], out["dense"]
    loss_rel = abs(fused["loss"] - dense["loss"]) / abs(dense["loss"])
    if not loss_rel <= LONG_LOSS_RTOL:
        _fail(f"S={LONG_SEQ} step-0 loss: fused {fused['loss']} vs dense "
              f"{dense['loss']} ({loss_rel} relative, limit "
              f"{LONG_LOSS_RTOL})")
    if not worst[1] <= TRAIN_GRAD_TOL:
        _fail(f"S={LONG_SEQ} step-0 gradient of {worst[0]}: fused vs dense "
              f"{worst[1]} in relative norm (limit {TRAIN_GRAD_TOL})")
    if not fused["peak"] < dense["peak"]:
        _fail(f"the fused-loss step peaked at {fused['peak']} bytes, not "
              f"below the dense-loss step's {dense['peak']}")
    state.tx = state.tx.inner
    return state, {
        "loss": {"fused": fused["loss"], "dense": dense["loss"]},
        "loss_rel_err": loss_rel, "grad_rel_err_max": worst[1],
        "grad_rel_err_worst_leaf": worst[0], "grad_tol": TRAIN_GRAD_TOL,
        "step_ms": {"fused": fused["ms"], "dense": dense["ms"]},
        "max_memory_allocated": {"fused": fused["peak"],
                                 "dense": dense["peak"]}}


def long_phase(torch):
    """Step 0 fused vs dense, then LONG_RUNS from the fused state, the
    launch counters zeroed just before each run and read just after, and
    one more step of each run under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models import build_lm, make_lm_train_step
    from kubeflow_tpu_torch.ops import _build

    cfg = train_config(torch)
    gen = torch.Generator(device="cuda").manual_seed(2026)
    tokens = torch.randint(0, cfg.vocab, (LONG_BATCH, LONG_SEQ),
                           device="cuda", generator=gen)
    state, step0 = long_step0(torch, cfg, tokens)
    runs, total = {}, {name: 0 for name in _build.LAUNCHES}
    for name, seq, window, steps in LONG_RUNS:
        run_cfg = dataclasses.replace(cfg, attn_window=window)
        state.apply_fn = build_lm(run_cfg)
        step = make_lm_train_step(cfg=run_cfg)
        batch = {"tokens": torch.randint(0, cfg.vocab, (LONG_BATCH, seq),
                                         device="cuda", generator=gen)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        losses, step_ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))   # syncs the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_build.LAUNCHES)
        if not all(math.isfinite(x) for x in losses):
            _fail(f"long[{name}]: non-finite losses {losses}")
        for kernel in TRAIN_KERNELS:
            if launches[kernel] != steps * cfg.layers:
                _fail(f"long[{name}]: {kernel} launched {launches[kernel]} "
                      f"times in {steps} steps, not {cfg.layers} per step")
        for kernel, count in launches.items():
            total[kernel] += count
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            float(metrics["loss"])
            traced_ms = (time.perf_counter() - t0) * 1e3
        steady = statistics.median(step_ms[1:])
        runs[name] = {
            "seq": seq, "window": window, "steps": steps, "losses": losses,
            "step_ms": step_ms, "step_ms_steady": steady,
            "tokens_per_s": LONG_BATCH * seq / steady * 1e3,
            "max_memory_allocated": peak, "launches": launches,
            "traced_step": {"step_ms": traced_ms, **device_breakdown(prof)}}
    return {"phase": "long", "batch": LONG_BATCH, "step0": step0,
            "runs": runs, "launches": total}


# --------------------------------------------------------------- resnet

# resnet phase: bench.py's primary section (bench.py:610-680).
RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES = 256, 224, 1000
RESNET_SMOOTHING, RESNET_STEPS = 0.1, 10
# ResNet-50's BatchNorms: the stem, 3 in each of 16 blocks, 4 projections.
RESNET_NORMS = 53
# The bf16 step-0 loss against the same parameters and batch through the
# f32 model (TF32 off), relative. The loss at init is ~ln(1000) = 6.9;
# bf16 activations through 53 convolutions and norms move the logits by
# a few bf16 ulps, the loss (a logsumexp over 1000 near-equal logits)
# far less.
RESNET_STEP0_RTOL = 1e-2
# resnet18 (width 8, f32, 32x32) on the card against the CPU, TF32 off:
# the same f32 arithmetic in another summation order (the CPU tests
# hold the port to the JAX package at this limit).
RESNET_CPU_TOL = 1e-4


class no_tf32:
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside, the
    previous settings restored after."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        b = self.torch.backends
        self.saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
        b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        b = self.torch.backends
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = self.saved


def leaf_errors(got, want) -> tuple:
    """Worst leaf of two states' leaves (keystr -> tensor): relative norm
    with the leaf's norm floored at 2^-8 x its group's RMS x sqrt(size),
    as ``tests/test_torch_resnet.py`` holds the port to the JAX package
    (a leaf whose gradient cancels, a last-stage BatchNorm over 8 values,
    is held at its group's scale)."""
    worst = (0.0, None)
    for group in ("['params']", "['batch_stats']", "['opt_state']"):
        keys = [k for k in want if k.startswith(group)]
        sq = sum(float(want[k].double().pow(2).sum()) for k in keys)
        rms = math.sqrt(sq / sum(want[k].numel() for k in keys))
        for k in keys:
            floor = ROW_RMS_FLOOR * rms * math.sqrt(want[k].numel())
            err = float((got[k].double() - want[k].double()).norm()) / max(
                float(want[k].double().norm()), floor)
            worst = max(worst, (err, k), key=lambda t: t[0])
    return worst


def resnet_cpu_check(torch) -> dict:
    """resnet18 (width 8, f32, 32x32) on the card and on the CPU from one
    seeded state, the zero-initialised scales moved: train-mode logits and
    statistics, eval logits, then one step (loss, every leaf of params,
    batch_stats and the trace), TF32 off."""
    from kubeflow_tpu_torch.models import (
        create_train_state,
        make_train_step,
        resnet18,
    )

    model = resnet18(num_classes=10, width=8, dtype=torch.float32)
    gen = torch.Generator().manual_seed(7)
    images = torch.randn((16, 32, 32, 3), generator=gen)
    labels = torch.randint(0, 10, (16,), generator=gen)
    states = {}
    for dev in ("cpu", "cuda"):
        states[dev] = create_train_state(model, seed=3,
                                         input_shape=(16, 32, 32, 3),
                                         device=dev)
    card_leaves = state_leaves(states["cuda"])
    with torch.no_grad():   # every BatchNorm scale, the zero ones included
        for key, cpu in state_leaves(states["cpu"]).items():
            if key.startswith("['params']") and key.endswith("['scale']"):
                cpu.add_(torch.randn(cpu.shape, generator=gen) * 0.2)
                card_leaves[key].copy_(cpu)
    out = {}
    with no_tf32(torch):
        for name, train in (("train_logits", True), ("eval_logits", False)):
            res = {dev: model(s.params, s.batch_stats,
                              images.to(dev), train=train)
                   for dev, s in states.items()}
            if train:
                res = {dev: r[0] for dev, r in res.items()}
            want = res["cpu"].detach()
            err = float((res["cuda"].detach().cpu() - want).abs().max()
                        / want.abs().max())
            if not err <= RESNET_CPU_TOL:
                _fail(f"resnet18 {name} on the card vs the CPU: {err} of "
                      f"the largest logit (limit {RESNET_CPU_TOL})")
            out[name] = err
        step = make_train_step()
        losses = {}
        for dev, s in states.items():
            _, metrics = step(s, {"image": images.to(dev),
                                  "label": labels.to(dev)})
            losses[dev] = float(metrics["loss"])
    loss_err = abs(losses["cuda"] - losses["cpu"])
    if not loss_err <= RESNET_CPU_TOL:
        _fail(f"resnet18 step loss on the card {losses['cuda']} vs the CPU "
              f"{losses['cpu']}")
    card = {k: v.detach().cpu() for k, v in
            state_leaves(states["cuda"]).items()
            if isinstance(v, torch.Tensor)}
    cpu = {k: v.detach() for k, v in state_leaves(states["cpu"]).items()
           if isinstance(v, torch.Tensor)}
    err, key = leaf_errors(card, cpu)
    if not err <= RESNET_CPU_TOL:
        _fail(f"resnet18 state after one step on the card vs the CPU: leaf "
              f"{key} at {err} (limit {RESNET_CPU_TOL})")
    return {**out, "step_loss": losses, "step_loss_abs_err": loss_err,
            "state_rel_err_max": err, "state_worst_leaf": key,
            "tol": RESNET_CPU_TOL}


def resnet_phase(torch, root) -> dict:
    """The CPU check, then ResNet-50 at bench.py's shape: the step-0 loss
    against the f32 model, RESNET_STEPS steps on one batch, an eval
    step, a traced step, and a checkpoint round trip under ``root``."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models import (
        create_train_state,
        cross_entropy,
        make_eval_step,
        make_optimizer,
        make_train_step,
        resnet50,
        resnet_flops_per_image,
    )
    from kubeflow_tpu_torch.models.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.models.transformer import param_count
    from kubeflow_tpu_torch.ops import _build

    tf32_default = {"cudnn": torch.backends.cudnn.allow_tf32,
                    "matmul": torch.backends.cuda.matmul.allow_tf32}
    cpu_check = resnet_cpu_check(torch)
    shape = (RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3)
    model = resnet50(num_classes=RESNET_CLASSES)
    state = create_train_state(model, seed=0, input_shape=shape,
                               tx=make_optimizer())
    gen = torch.Generator(device="cuda").manual_seed(2027)
    batch = {"image": torch.randn(shape, generator=gen,
                                  device="cuda").to(torch.bfloat16),
             "label": torch.randint(0, RESNET_CLASSES, (RESNET_BATCH,),
                                    generator=gen, device="cuda")}
    model32 = resnet50(num_classes=RESNET_CLASSES, dtype=torch.float32)
    with no_tf32(torch), torch.no_grad():
        logits, _ = model32(state.params, state.batch_stats, batch["image"],
                            train=True)
        loss32 = float(cross_entropy(logits, batch["label"],
                                     RESNET_SMOOTHING))
        del logits
    stats0 = {k: v.clone() for k, v in
              state_leaves(state).items() if "batch_stats" in k}
    step = make_train_step(smoothing=RESNET_SMOOTHING)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    _build.reset_launches()
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))   # syncs the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_build.LAUNCHES)
    for name in BN_KERNELS:   # each of ResNet-50's 53 BatchNorms, a step
        if launches[name] != RESNET_NORMS * RESNET_STEPS:
            _fail(f"resnet50: {launches[name]} {name} launches in "
                  f"{RESNET_STEPS} steps, not {RESNET_NORMS} a step")
    step0_rel = abs(losses[0] - loss32) / abs(loss32)
    if not step0_rel <= RESNET_STEP0_RTOL:
        _fail(f"resnet50 bf16 step-0 loss {losses[0]} vs f32 {loss32}: "
              f"{step0_rel} relative (limit {RESNET_STEP0_RTOL})")
    if not all(math.isfinite(x) for x in losses):
        _fail(f"resnet50: non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        _fail(f"resnet50: the loss did not fall on a fixed batch: {losses}")
    now = state_leaves(state)
    moved = sum(not torch.equal(now[k], v) for k, v in stats0.items())
    if moved != len(stats0):
        _fail(f"resnet50: {len(stats0) - moved} of {len(stats0)} "
              "batch_stats leaves did not move in training")
    evaluation = make_eval_step()(state, batch)
    eval_loss = float(evaluation["loss"])
    if not math.isfinite(eval_loss):
        _fail(f"resnet50 eval loss {eval_loss}")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        traced_ms = (time.perf_counter() - t0) * 1e3

    directory = os.path.join(root, "resnet50")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    CheckpointManager(directory).save(state.step, state)
    save_s = time.perf_counter() - t0
    like = create_train_state(model, seed=1, input_shape=shape)
    t0 = time.perf_counter()
    restored = CheckpointManager(directory).restore_latest_valid(like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if restored is None or not states_equal(torch, restored[0], state):
        _fail("resnet50: the checkpoint did not restore leaf by leaf equal")
    n_leaves = {g: sum(g in k for k in state_leaves(state))
                for g in ("['params']", "['batch_stats']", ".trace[")}
    del restored, like

    steady = statistics.median(step_ms[1:])
    images_per_s = RESNET_BATCH / steady * 1e3
    flops = resnet_flops_per_image("resnet50", RESNET_IMAGE)
    return {
        "phase": "resnet", "model": "resnet50",
        "params": param_count(state.params), "batch": RESNET_BATCH,
        "image": RESNET_IMAGE, "classes": RESNET_CLASSES,
        "smoothing": RESNET_SMOOTHING, "tf32_default": tf32_default,
        "cpu_check": cpu_check,
        "step0": {"loss_bf16": losses[0], "loss_f32": loss32,
                  "rel_err": step0_rel, "tol": RESNET_STEP0_RTOL,
                  "f32_tf32": False},
        "losses": losses, "step_ms": step_ms, "step_ms_median": steady,
        "images_per_s": images_per_s,
        "mfu": 3 * flops * images_per_s / BF16_FLOPS_PER_S,
        "max_memory_allocated": peak,
        "eval": {"loss": eval_loss,
                 "accuracy": float(evaluation["accuracy"])},
        "batch_stats_leaves_moved": moved, "launches": launches,
        "checkpoint": {"save_s": save_s, "restore_s": restore_s,
                       "leaves": n_leaves, "restored_equal": True},
        "traced_step": {"step_ms": traced_ms, **device_breakdown(prof)},
    }


# ---------------------------------------------------------- speculative

# spec phase: bench.py's two speculative sections (bench.py:485-555 and
# 967-979) at their defaults: (name, prompt length, new tokens), draft 8,
# n-gram 3, the prompt a 64-token random segment (numpy seed 0) tiled to
# its length; each greedy, then sampled at SPEC_TEMPERATURE.
SPEC_RUNS = (("spec-b1", 1024, 256), ("spec-b1-p8k", 8192, 128))
SPEC_DRAFT, SPEC_NGRAM, SPEC_PERIOD = 8, 3, 64
SPEC_TEMPERATURE, SPEC_SEED = 0.8, 5
# spec_serve: 8 tiled prompts (numpy seeds 100-107), the last two sampled.
SPEC_SERVE_LENGTHS = (1024, 768, 512, 256, 640, 384, 896, 320)
SPEC_SERVE_TEMPS = (0.0,) * 6 + (0.8, 0.8)
SPEC_SERVE_SEEDS = (None,) * 6 + (21, 22)
# What a speculative run must launch: the flash forward, once a layer for
# its prefill (the verify chunks' 9 rows and more take dense products).
SPEC_KERNELS = ("flash_attention",)


def tiled_prompt(vocab: int, length: int, seed: int) -> list[int]:
    """bench.py's speculative prompt: a SPEC_PERIOD-token random segment
    (numpy ``default_rng(seed)``) tiled to ``length``."""
    import numpy as np

    base = np.random.default_rng(seed).integers(0, vocab, size=SPEC_PERIOD)
    return [int(t) for t in
            np.tile(base, -(-length // SPEC_PERIOD))[:length]]


def noise_rows(torch, seed, n: int, vocab: int):
    """The first ``n`` Gumbel rows a request seeded ``seed`` draws, one
    (1, vocab) row at a time as ``generate`` draws them: (n, vocab)."""
    from kubeflow_tpu_torch.models.decoding import gumbel_noise, make_generator

    gen = make_generator(seed, "cuda")
    return torch.cat([gumbel_noise(gen, (1, vocab), "cuda")
                      for _ in range(n)])


def generate_scores(torch, cfg, params, prompt, ref, at, temperature, seed):
    """The scores ``generate`` took the argmax of at token ``at`` of its
    own stream ``ref``: its very calls replayed (the prefill, then one
    token a step on a cache of its capacity), plus temperature times that
    step's Gumbel row when sampling. (vocab,) f32."""
    from kubeflow_tpu_torch.models.decoding import KVCache, forward_with_cache

    cache = KVCache.init(cfg, 1, len(prompt) + len(ref) - 1)
    logits, cache = forward_with_cache(cfg, params, [prompt], cache,
                                       last_logits_only=True)
    for token in ref[:at]:
        logits, cache = forward_with_cache(cfg, params, [[token]], cache)
    row = logits[0, -1].float()
    if temperature > 0.0:
        row = row + temperature * noise_rows(torch, seed, at + 1,
                                             cfg.vocab)[at]
    return row


def first_divergence(torch, cfg, params, prompt, got, ref, temperature,
                     seed, label) -> dict | None:
    """Gate 1: at the first token where a speculative stream ``got``
    leaves ``generate``'s ``ref``, generate's own scores there put the
    two tokens within TOL_LOGITS. None when the streams agree."""
    at = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), None)
    if at is None:
        return None
    row = generate_scores(torch, cfg, params, prompt, ref, at, temperature,
                          seed)
    if int(row.argmax()) != ref[at]:
        _fail(f"{label}: the replay of generate does not give its token "
              f"{ref[at]} at {at}")
    gap = float(row[ref[at]] - row[got[at]])
    if not gap <= TOL_LOGITS:
        _fail(f"{label}: at token {at} the stream took {got[at]}, "
              f"{gap} below generate's {ref[at]} (limit {TOL_LOGITS})")
    return {"at": at, "gap": gap}


def plain_gap(torch, cfg, params32, prompt, tokens, temperature,
              seed) -> float:
    """Gate 2: one f32 plain full-sequence forward of prompt + tokens;
    the largest amount by which an emitted token's score falls below its
    position's best (scores: logits, plus temperature times the token's
    Gumbel row when sampling). Fails past TOL_LOGITS."""
    from kubeflow_tpu_torch.models import build_lm
    from kubeflow_tpu_torch.models.transformer import tied_head

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p, n = len(prompt), len(tokens)
    with torch.no_grad():
        hidden = build_lm(cfg32, use_flash=False)(
            params32, torch.tensor([prompt + tokens], device="cuda"),
            return_hidden=True)
        rows = tied_head(hidden[:, p - 1:p - 1 + n],
                         params32["embed"]["embedding"], torch.float32)[0]
    if temperature > 0.0:
        rows = rows + temperature * noise_rows(torch, seed, n, cfg.vocab)
    picked = rows.gather(1, torch.tensor(tokens, device="cuda")[:, None])
    gap = float((rows.max(-1).values - picked[:, 0]).max())
    if not gap <= TOL_LOGITS:
        _fail(f"an emitted token's f32 plain score is {gap} below its "
              f"position's best (limit {TOL_LOGITS})")
    return gap


def f32_params(torch, params):
    from kubeflow_tpu_torch.models.optim import tree_map

    return tree_map(lambda t: t.detach().float(), params)


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def spec_phase(torch, cfg, params):
    """``speculative_generate`` at bench's two configs on the serve
    params, greedy and sampled, with the launch counters zeroed just
    before the speculative runs and read just after; the same calls of
    ``generate`` beside them; gates 1 and 2 on every stream."""
    from kubeflow_tpu_torch.models.decoding import generate
    from kubeflow_tpu_torch.models.speculative import speculative_generate
    from kubeflow_tpu_torch.ops import _build

    params32 = f32_params(torch, params)
    kw = dict(draft=SPEC_DRAFT, ngram=SPEC_NGRAM)
    # Warm-up: the verify chunk's first dense products and allocations.
    speculative_generate(cfg, params, [tiled_prompt(cfg.vocab, 256, 0)], 16,
                         **kw)
    runs, total = {}, {name: 0 for name in _build.LAUNCHES}
    for name, plen, new in SPEC_RUNS:
        prompt = tiled_prompt(cfg.vocab, plen, 0)
        run = {"prompt": plen, "new_tokens": new, "draft": SPEC_DRAFT,
               "ngram": SPEC_NGRAM}
        for mode, temp, seed in (("greedy", 0.0, None),
                                 ("sampled", SPEC_TEMPERATURE, SPEC_SEED)):
            torch.cuda.synchronize()
            _build.reset_launches()
            (out, stats), dt = timed(torch, lambda: speculative_generate(
                cfg, params, [prompt], new, temperature=temp, rng=seed,
                return_stats=True, **kw))
            launches = dict(_build.LAUNCHES)
            for kernel, count in launches.items():
                total[kernel] += count
            for kernel in SPEC_KERNELS:
                if launches[kernel] != cfg.layers:
                    _fail(f"spec[{name}]: {kernel} launched "
                          f"{launches[kernel]} times, not once a layer")
            ref, gen_dt = timed(torch, lambda: generate(
                cfg, params, [prompt], new, temperature=temp, rng=seed))
            got, ref = out[0].tolist(), ref[0].tolist()
            if len(got) != new or not all(0 <= t < cfg.vocab for t in got):
                _fail(f"spec[{name}]: a malformed stream")
            run[mode] = {
                "tok_s": new / dt, "decode_step_ms": dt / new * 1e3,
                "accept_rate": stats.accept_rate,
                "tokens_per_verify": stats.tokens_per_verify,
                "verify_calls": stats.verify_calls,
                "generate_tok_s": new / gen_dt,
                "generate_decode_step_ms": gen_dt / new * 1e3,
                "equal_to_generate": got == ref,
                "first_divergence": first_divergence(
                    torch, cfg, params, prompt, got, ref, temp, seed,
                    f"spec[{name}/{mode}]"),
                "plain_gap_max": plain_gap(torch, cfg, params32, prompt,
                                           got, temp, seed),
                "launches": launches}
        runs[name] = run
    # spec-b1's greedy run once more under the profiler: where a verify's
    # device time goes, and how idle the card is between verifies.
    from torch.profiler import ProfilerActivity, profile

    name, plen, new = SPEC_RUNS[0]
    prompt = tiled_prompt(cfg.vocab, plen, 0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, traced_s = timed(torch, lambda: speculative_generate(
            cfg, params, [prompt], new, **kw))
    return {"phase": "spec", "runs": runs, "launches": total,
            "logit_tol": TOL_LOGITS,
            "traced": {"run": name, "wall_s": traced_s,
                       **device_breakdown(prof)}}


def spec_serve_phase(torch, cfg, params):
    """The speculative engine (``make_engine(spec_ngram=True)``) on 8
    tiled requests with its ``Scheduler``, the counters zeroed just before
    and read just after; then the same requests on a lockstep engine,
    whose streams must equal ``generate``; gates 1 and 2 on the
    speculative streams."""
    from kubeflow_tpu_torch.models.decoding import generate
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.serving import StreamingBatcher, make_engine

    prompts = [tiled_prompt(cfg.vocab, n, 100 + i)
               for i, n in enumerate(SPEC_SERVE_LENGTHS)]
    temps, seeds = list(SPEC_SERVE_TEMPS), list(SPEC_SERVE_SEEDS)
    engine = make_engine(cfg, params, max_batch=8, max_len=2048,
                         spec_ngram=True, spec_draft=SPEC_DRAFT,
                         spec_ngram_n=SPEC_NGRAM)
    if not (isinstance(engine, StreamingBatcher) and engine.spec_ngram):
        _fail("make_engine(spec_ngram=True) did not build a speculative "
              "engine")
    torch.cuda.synchronize()
    _build.reset_launches()
    events, wall = stream(torch, engine, prompts, temps, seeds,
                          new_tokens=NEW_TOKENS)
    launches = dict(_build.LAUNCHES)
    for kernel in SPEC_KERNELS:
        if launches[kernel] <= 0:
            _fail(f"spec_serve: {kernel} was never launched")
    lock = make_engine(cfg, params, max_batch=8, max_len=2048)
    lock_events, lock_wall = stream(torch, lock, prompts, temps, seeds,
                                    new_tokens=NEW_TOKENS)
    params32 = f32_params(torch, params)
    gates, equal = [], 0
    for i, prompt in enumerate(prompts):
        got = next(e for e in events[i] if e.get("done"))["tokens"]
        locked = next(e for e in lock_events[i] if e.get("done"))["tokens"]
        ref = generate(cfg, params, [prompt], NEW_TOKENS,
                       temperature=temps[i], rng=seeds[i])[0].tolist()
        if locked != ref:
            _fail(f"spec_serve: the lockstep engine's request {i} differs "
                  "from generate")
        if len(got) != NEW_TOKENS:
            _fail(f"spec_serve: request {i} streamed {len(got)} tokens")
        equal += got == ref
        gates.append({
            "first_divergence": first_divergence(
                torch, cfg, params, prompt, got, ref, temps[i], seeds[i],
                f"spec_serve[{i}]"),
            "plain_gap_max": plain_gap(torch, cfg, params32, prompt, got,
                                       temps[i], seeds[i])})
    counts = {phase: engine.cycle_seconds[phase].count
              for phase in ("verify", "commit")}
    if not counts["verify"] == counts["commit"] == \
            engine.spec_verifies_total > 0:
        _fail(f"spec_serve: verify/commit histograms {counts}, "
              f"{engine.spec_verifies_total} verifies")

    def decode_rate(eng):
        decode_s = eng.profiler.snapshot()["decode"]["total_s"]
        return (len(prompts) * (NEW_TOKENS - 1)) / decode_s, decode_s

    spec_rate, spec_decode_s = decode_rate(engine)
    lock_rate, lock_decode_s = decode_rate(lock)
    return {
        "phase": "spec_serve", "requests": len(prompts),
        "new_tokens": NEW_TOKENS, "wall_s": wall, "lockstep_wall_s": lock_wall,
        "decode_tok_s": spec_rate, "decode_s": spec_decode_s,
        "lockstep_decode_tok_s": lock_rate,
        "lockstep_decode_s": lock_decode_s,
        "histogram_counts": counts,
        "verifies": engine.spec_verifies_total,
        "drafted": engine.spec_drafted_total,
        "accepted": engine.spec_accepted_total,
        "accept_rate": engine.spec_accepted_total / engine.spec_drafted_total,
        "streams_equal_to_generate": equal, "gates": gates,
        "cycle_profile": engine.profiler.compact(), "launches": launches,
    }


# ------------------------------------------------------------------ moe

# moe phase: bench.py's lm_moe sections (bench.py:858-868) on the train
# config: 8 experts in every 2nd block, f32 parameters, bf16 compute,
# batch 4 x 2048, seed 0 (369,148,928 parameters).
MOE_EXPERTS, MOE_EVERY, MOE_STEPS = 8, 2, 6
MOE_PARAMS = 369_148_928
# The fallback engine's 4 requests: prompt lengths, 32 new tokens each,
# the last one sampled.
MOE_SERVE_LENGTHS, MOE_NEW_TOKENS = (1024, 768, 512, 256), 32
MOE_SERVE_TEMPS, MOE_SERVE_SEEDS = (0.0, 0.0, 0.0, 0.8), (None, None, None, 13)
# MoE decode against the f32 plain path: the share of token-layer
# routings that may differ (bf16 vs f32 router inputs flip near-tied
# choices; a flipped token's own logits are not compared).
MOE_ROUTING_FLIP_MAX = 0.01
MOE_DECODE_PROMPT = 512


def moe_config(torch, router: str = "topk"):
    return dataclasses.replace(train_config(torch), moe_experts=MOE_EXPERTS,
                               moe_every=MOE_EVERY, moe_router=router)


class Capturing:
    """The LM as a train state's ``apply_fn`` that keeps the MoE
    intermediates of its last call (no extra work: the MoE step asks for
    them anyway)."""

    def __init__(self, model):
        self.model, self.cfg, self.last = model, model.cfg, None

    def __call__(self, *args, **kwargs):
        out = self.model(*args, **kwargs)
        if isinstance(out, tuple):
            self.last = out[1]
        return out


class RoutingPin:
    """Stands in for the port's top-k choice (``transformer.
    _topk_choices``): it records every MoE block's choices in one pass
    and hands them, call by call, to the next, counting the token-layer
    choices that pass would have made otherwise. The gates still come
    from each pass's own router probabilities."""

    def __init__(self, choose):
        self.choose, self.recorded, self.replay = choose, [], None
        self.flips = self.routings = 0

    def __call__(self, probs, k):
        own = self.choose(probs, k)
        if self.replay is None:
            self.recorded.append(own)
            return own
        pinned = self.replay.pop(0)
        self.flips += choices_differ(own, pinned)
        self.routings += own[0].shape[0] * own[0].shape[1]
        return pinned


def choices_differ(own, pinned) -> int:
    """Tokens whose set of choices differs between two lists of one-hots."""
    differs = sum((a != b).any(-1).int() for a, b in zip(own, pinned))
    return int((differs > 0).sum())


def moe_step0(torch, cfg, state, tokens) -> dict:
    """Gate 4: step-0 loss (aux term included) and every leaf's gradient
    of the kernel path against ``build_lm(use_flash=False)`` (its
    products widened, ``widened_products``), with the
    routing pinned: a bf16 attention core moves router inputs by an ulp,
    which flips near-tied expert choices and moves whole tokens between
    experts, so the kernel pass routes to the plain pass's choices
    (``RoutingPin``) and the two differ only in the attention core. The
    kernel path's own routing is read too: its flips and its unpinned
    worst leaf are printed, not gated."""
    from kubeflow_tpu_torch.models import build_lm, lm_loss
    from kubeflow_tpu_torch.models import transformer
    from kubeflow_tpu_torch.models.optim import flatten
    from kubeflow_tpu_torch.models.transformer import moe_aux_total

    paths = [path for path, _ in flatten(state.params)]
    leaves = [p for _, p in flatten(state.params)]
    real = transformer._topk_choices
    pin = RoutingPin(real)
    losses, auxes, grads = {}, {}, {}
    try:
        for name, use_flash in (("plain", False), ("kernel", True),
                                ("kernel_unpinned", True)):
            if name == "kernel":
                pin.replay = list(pin.recorded)
            transformer._topk_choices = pin if name != "kernel_unpinned" \
                else real
            with (contextlib.nullcontext() if use_flash
                  else widened_products(torch)):
                logits, inter = build_lm(cfg, use_flash=use_flash)(
                    state.params, tokens, return_intermediates=True)
            aux = moe_aux_total(inter)
            loss = lm_loss(logits, tokens) + cfg.moe_aux_weight * aux
            grads[name] = torch.autograd.grad(loss, leaves)
            losses[name] = float(loss.detach())
            auxes[name] = float(aux.detach())
            del logits, inter, loss
    finally:
        transformer._topk_choices = real

    def rel(a, b):
        return {path: float((g - r).norm() / r.norm())
                for path, g, r in zip(paths, grads[a], grads[b])}

    per_leaf = rel("kernel", "plain")
    worst, err = max(per_leaf.items(), key=lambda kv: kv[1])
    unpinned = max(rel("kernel_unpinned", "plain").items(),
                   key=lambda kv: kv[1])
    if not abs(losses["kernel"] - losses["plain"]) <= TRAIN_LOSS_TOL:
        _fail(f"moe step-0 loss {losses} differs by more than "
              f"{TRAIN_LOSS_TOL}")
    if not err <= TRAIN_GRAD_TOL:
        _fail(f"moe step-0 gradient of {worst} is {err} from the plain "
              f"path's in relative norm (limit {TRAIN_GRAD_TOL})")
    return {"loss": losses, "aux": auxes, "grad_rel_err_max": err,
            "grad_rel_err_worst_leaf": worst, "grad_tol": TRAIN_GRAD_TOL,
            "routing_flips": pin.flips, "routings": pin.routings,
            "unpinned_worst_leaf": unpinned}


def moe_parts_ms(torch, timer, cfg, block, x) -> dict:
    """Forward device ms of the MoE layer's parts on one block at the
    train shape (CUDA events): the router and routing, the dispatch
    einsum, the experts' GEMMs, the combine einsum."""
    from kubeflow_tpu_torch.models.transformer import (
        moe_combine,
        moe_dispatch,
        moe_experts,
        moe_route,
    )

    with torch.no_grad():
        dispatch_t, combine_t = moe_route(cfg, block, x)
        expert_in = moe_dispatch(cfg, x, dispatch_t)
        expert_out = moe_experts(cfg, block, expert_in)
        return {
            "routing": timer(lambda: moe_route(cfg, block, x), iters=10),
            "dispatch": timer(lambda: moe_dispatch(cfg, x, dispatch_t),
                              iters=10),
            "experts": timer(lambda: moe_experts(cfg, block, expert_in),
                             iters=10),
            "combine": timer(lambda: moe_combine(cfg, combine_t,
                                                 expert_out), iters=10)}


def moe_train(torch, timer, router: str, tokens) -> dict:
    """MOE_STEPS steps of ``make_lm_train_step`` for one router from a
    fresh seed-0 state, the counters zeroed just before and read just
    after (8 launches of each flash kernel a step), routing diagnostics
    from each step (per-expert load within the capacity, no slot held
    twice), finite and falling losses; then one step under the profiler
    and the forward parts timed."""
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models import (
        build_lm,
        create_lm_state,
        make_lm_train_step,
    )
    from kubeflow_tpu_torch.models.transformer import (
        _moe_capacity,
        param_count,
    )
    from kubeflow_tpu_torch.ops import _build

    cfg = moe_config(torch, router)
    capture = Capturing(build_lm(cfg))
    state = create_lm_state(capture.model, seed=0)
    state.apply_fn = capture
    count = param_count(state.params)
    if count != MOE_PARAMS:
        _fail(f"the MoE config has {count} parameters, not {MOE_PARAMS}")
    out = {"router": router, "params": count}
    if router == "topk":
        out["step0"] = moe_step0(torch, cfg, state, tokens)
    cap = _moe_capacity(cfg, TRAIN_SEQ)
    step = make_lm_train_step(cfg=cfg)
    batch = {"tokens": tokens}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses, step_ms, loads, aux = [], [], [], []
    for _ in range(MOE_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))   # syncs the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        sown = capture.last
        for blk, val in sown.items():
            if float(val["moe_expert_load"].max()) > TRAIN_BATCH * cap:
                _fail(f"moe[{router}] {blk}: an expert took more than "
                      f"{TRAIN_BATCH} x {cap} tokens")
            if float(val["moe_slot_max"]) > 1:
                _fail(f"moe[{router}] {blk}: a slot held two tokens")
        loads.append({blk: val["moe_expert_load"].tolist()
                      for blk, val in sown.items()})
        aux.append({blk: float(val["moe_aux"].detach())
                    for blk, val in sown.items() if "moe_aux" in val})
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in TRAIN_KERNELS:
        if launches[name] != MOE_STEPS * cfg.layers:
            _fail(f"moe[{router}]: {name} launched {launches[name]} times "
                  f"in {MOE_STEPS} steps, not {cfg.layers} per step")
    if not all(math.isfinite(x) for x in losses):
        _fail(f"moe[{router}]: non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        _fail(f"moe[{router}]: the loss did not fall: {losses}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        traced_ms = (time.perf_counter() - t0) * 1e3
    gen = torch.Generator(device="cuda").manual_seed(77)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.dim), generator=gen,
                    device="cuda").to(cfg.dtype)
    parts = moe_parts_ms(torch, timer, cfg, state.params["block_1"]["moe"],
                         x)
    steady = statistics.median(step_ms[1:])
    out.update({
        "capacity": cap, "losses": losses, "step_ms": step_ms,
        "step_ms_median": steady,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady * 1e3,
        "max_memory_allocated": peak, "launches": launches,
        "aux_per_layer": aux, "expert_load_per_layer": loads,
        "forward_parts_ms": parts,
        "traced_step": {"step_ms": traced_ms, **device_breakdown(prof)}})
    return out


def moe_decode_check(torch, cfg, params, prompt) -> dict:
    """Gate 6: the prefill's and first decode step's logits of the MoE
    model (bf16, kernels) against the f32 plain path on the same weights,
    at every position every MoE layer routed alike on both paths (the
    routing is read by a wrapper around the decode path's MoE layer that
    recomputes its dispatch); the share of differing token-layer
    routings is printed and fails above MOE_ROUTING_FLIP_MAX."""
    from kubeflow_tpu_torch.models import decoding
    from kubeflow_tpu_torch.models.decoding import KVCache, forward_with_cache
    from kubeflow_tpu_torch.models.transformer import moe_route

    real, seen = decoding.moe_ffn, []

    def recording(cfg_, p, x, sow=None):
        with torch.no_grad():
            seen.append(moe_route(cfg_, p, x)[0].sum(-1) > 0)  # (B, S, E)
        return real(cfg_, p, x, sow)

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = f32_params(torch, params)
    routes, logits = {}, {}
    decoding.moe_ffn = recording
    try:
        for name, run_cfg, run_params in (("kernel", cfg, params),
                                          ("plain", cfg32, params32)):
            seen.clear()
            cache = KVCache.init(run_cfg, 1, len(prompt) + 8)
            prefill, cache = forward_with_cache(run_cfg, run_params,
                                                [prompt], cache)
            pre_routes = list(seen)
            seen.clear()
            if name == "kernel":
                nxt = prefill[:, -1].argmax(-1, keepdim=True)
            step, _ = forward_with_cache(run_cfg, run_params, nxt, cache)
            routes[name] = (torch.stack(pre_routes), torch.stack(seen))
            logits[name] = (prefill.float(), step.float())
    finally:
        decoding.moe_ffn = real
    torch.cuda.synchronize()
    # (layers, 1, S, E) masks: a token-layer routing differs when its set
    # of experts (after capacity drops) differs.
    pre_diff = (routes["kernel"][0] != routes["plain"][0]).any(-1)[:, 0]
    step_diff = (routes["kernel"][1] != routes["plain"][1]).any(-1)[:, 0]
    routings = pre_diff.numel() + step_diff.numel()
    differing = int(pre_diff.sum() + step_diff.sum())
    same = ~pre_diff.any(0)                      # (S,) positions
    errs = (logits["kernel"][0] - logits["plain"][0]).abs().amax(-1)[0]
    prefill_err = float(errs[same].max()) if bool(same.any()) else None
    step_same = not bool(step_diff.any())
    step_err = (float((logits["kernel"][1] - logits["plain"][1]).abs().max())
                if step_same else None)
    share = differing / routings
    if share > MOE_ROUTING_FLIP_MAX:
        _fail(f"moe decode: {differing} of {routings} token-layer routings "
              f"differ from the f32 plain path ({share:.4f} > "
              f"{MOE_ROUTING_FLIP_MAX})")
    for label, err in (("prefill", prefill_err), ("first step", step_err)):
        if err is not None and not err <= TOL_LOGITS:
            _fail(f"moe decode: {label} logits differ from the f32 plain "
                  f"path by {err} > {TOL_LOGITS}")
    if not all(torch.isfinite(t).all() for t in logits["kernel"]):
        _fail("moe decode: non-finite logits")
    return {"prompt": len(prompt), "routings": routings,
            "routings_differing": differing, "share": share,
            "positions_compared": int(same.sum()),
            "prefill_logit_max_abs_err": prefill_err,
            "step_logit_max_abs_err": step_err, "logit_tol": TOL_LOGITS}


def moe_serve(torch) -> dict:
    """A fresh bf16 init of the top-k MoE config through ``make_engine``,
    which must return the ``GenerateFallbackEngine``: 4 requests with the
    counters zeroed just before and read just after (every serving kernel
    must launch), each stream equal to ``generate`` on the same request
    bit for bit (gate 3), then gate 6."""
    from kubeflow_tpu_torch.models.decoding import generate
    from kubeflow_tpu_torch.models.transformer import init_params
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.serving import GenerateFallbackEngine, make_engine

    cfg = moe_config(torch)
    params = init_params(cfg, seed=0, device="cuda", dtype=cfg.dtype)
    engine = make_engine(cfg, params, max_batch=8, max_len=2048)
    if not isinstance(engine, GenerateFallbackEngine):
        _fail(f"make_engine served the MoE config with {type(engine)}")
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist()
               for n in MOE_SERVE_LENGTHS]
    temps, seeds = list(MOE_SERVE_TEMPS), list(MOE_SERVE_SEEDS)
    ttft = []
    torch.cuda.synchronize()
    _build.reset_launches()
    events, wall = stream(torch, engine, prompts, temps, seeds,
                          new_tokens=MOE_NEW_TOKENS, first_token_s=ttft)
    launches = dict(_build.LAUNCHES)
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            _fail(f"moe serve: kernel {name} was never launched")
    for i, prompt in enumerate(prompts):
        got = next(e for e in events[i] if e.get("done"))["tokens"]
        ref = generate(cfg, params, [prompt], MOE_NEW_TOKENS,
                       temperature=temps[i], rng=seeds[i])[0].tolist()
        if got != ref:
            _fail(f"moe serve: request {i} differs from generate")
    check = moe_decode_check(torch, cfg, params, prompts[0][:MOE_DECODE_PROMPT])
    return {"engine": type(engine).__name__, "wall_s": wall,
            "ttft_s": ttft, "requests": len(prompts),
            "new_tokens": MOE_NEW_TOKENS, "launches": launches,
            "decode_check": check,
            "cycle_profile": engine.profiler.compact()}


def moe_phase(torch, timer) -> dict:
    """Both routers' training, then the fallback engine and MoE decode;
    ``launches`` sums the three runs' counts."""
    gen = torch.Generator(device="cuda").manual_seed(2027)
    tokens = torch.randint(0, train_config(torch).vocab,
                           (TRAIN_BATCH, TRAIN_SEQ),
                           device="cuda", generator=gen)
    runs = {}
    for router in ("topk", "expert_choice"):
        runs[router] = moe_train(torch, timer, router, tokens)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    serve = moe_serve(torch)
    launches = {name: sum(run["launches"][name] for run in runs.values())
                + serve["launches"][name] for name in serve["launches"]}
    return {"phase": "moe", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "experts": MOE_EXPERTS, "every": MOE_EVERY, "runs": runs,
            "serve": serve, "launches": launches}


# ------------------------------------------------------------- parallel

# parallel phase: the mesh path at world 1 (one card, one NCCL rank)
# against the meshless path on the same seed and batch: the LM step (the
# train phase's config and batch) and the ResNet-50 step (the resnet
# phase's), each held to PARALLEL_RTOL (loss relative, every leaf after
# the step in relative norm); then PARALLEL_STEPS timed steps of each LM
# path and PARALLEL_RESNET_STEPS of each ResNet path. The ring's hop
# arithmetic runs at RING_SHAPE, S split into RING_SHARDS shards driven
# in one process, against mha_reference in f32 within TOL_BF16.
PARALLEL_RTOL = 1e-5
PARALLEL_STEPS, PARALLEL_RESNET_STEPS = 6, 3
RING_SHAPE = dict(b=1, h=8, h_kv=2, s=8192, d=128)
RING_SHARDS = 4
RING_WINDOW = 1024


def rel_err(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def worst_leaf(torch, got: dict, want: dict) -> tuple:
    """(relative norm, path) of the worst leaf; whether all are equal."""
    errs = [(rel_err(got[k], want[k]), k) for k in want]
    equal = all(torch.equal(got[k].detach(), want[k].detach())
                for k in want)
    return max(errs), equal


def timed_steps(torch, step, state, batch, n: int) -> tuple:
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])   # syncs the step
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, ms


def parallel_lm(torch, mesh) -> dict:
    """Step 0 of the LM on the mesh against the meshless step, then
    PARALLEL_STEPS timed steps of each; the launch counters are zeroed
    just before the mesh path's steps and read just after."""
    from kubeflow_tpu_torch.models import (
        build_lm,
        create_lm_state,
        gather_state,
        make_lm_train_step,
    )
    from kubeflow_tpu_torch.models.optim import flatten
    from kubeflow_tpu_torch.ops import _build

    cfg, state, tokens = train_setup(torch)
    batch = {"tokens": tokens}
    plain_step = make_lm_train_step(cfg=cfg)
    mesh_state = create_lm_state(build_lm(cfg, mesh), seed=0, mesh=mesh)
    mesh_step = make_lm_train_step(mesh, cfg=cfg)
    state, plain = plain_step(state, batch)
    _build.reset_launches()
    mesh_state, meshed = mesh_step(mesh_state, batch)
    torch.cuda.synchronize()
    step0_launches = dict(_build.LAUNCHES)
    loss, want = float(meshed["loss"]), float(plain["loss"])
    loss_err = abs(loss - want) / abs(want)
    if not loss_err <= PARALLEL_RTOL:
        _fail(f"mesh LM step-0 loss {loss} vs meshless {want}")
    (err, leaf), equal = worst_leaf(
        torch, dict(flatten(gather_state(mesh_state).params)),
        dict(flatten(state.params)))
    if not err <= PARALLEL_RTOL:
        _fail(f"mesh LM leaf {leaf} after step 0 is {err} from the "
              f"meshless step's in relative norm")
    if not (equal and loss == want):
        _fail(f"mesh LM step 0 is not bit-equal to the meshless step "
              f"(loss {loss} vs {want}, worst leaf {leaf} at {err})")
    state, plain_ms = timed_steps(torch, plain_step, state, batch,
                                  PARALLEL_STEPS)
    _build.reset_launches()
    mesh_state, mesh_ms = timed_steps(torch, mesh_step, mesh_state, batch,
                                      PARALLEL_STEPS)
    launches = dict(_build.LAUNCHES)
    for name in TRAIN_KERNELS:
        if launches[name] != PARALLEL_STEPS * cfg.layers:
            _fail(f"{name} launched {launches[name]} times in "
                  f"{PARALLEL_STEPS} mesh steps, not {cfg.layers} a step")
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    plain_med = statistics.median(plain_ms[1:])
    mesh_med = statistics.median(mesh_ms[1:])
    return {"loss": {"mesh": loss, "meshless": want}, "loss_rel_err": loss_err,
            "leaf_rel_err_max": err, "worst_leaf": leaf,
            "bit_equal": equal and loss == want,
            "step0_launches": {n: step0_launches[n] for n in TRAIN_KERNELS},
            "step_ms": {"mesh": mesh_ms, "meshless": plain_ms},
            "step_ms_median": {"mesh": mesh_med, "meshless": plain_med},
            "tokens_per_s": {"mesh": tokens_per_step / mesh_med * 1e3,
                             "meshless": tokens_per_step / plain_med * 1e3},
            "launches": launches,
            "launches_per_step": {n: launches[n] / PARALLEL_STEPS
                                  for n in TRAIN_KERNELS}}


def parallel_resnet(torch, mesh) -> dict:
    """One ResNet-50 step on the mesh against the meshless step (loss,
    params and batch_stats), then PARALLEL_RESNET_STEPS timed steps of
    each; the mesh steps' launches (the BatchNorm kernels once a norm a
    step, on the group path: moments over 1 / (rows * n), then the
    all-reduces)."""
    from kubeflow_tpu_torch.models import (
        create_train_state,
        gather_state,
        make_optimizer,
        make_train_step,
        resnet50,
    )
    from kubeflow_tpu_torch.models.optim import flatten
    from kubeflow_tpu_torch.ops import _build

    shape = (RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3)
    model = resnet50(num_classes=RESNET_CLASSES)
    gen = torch.Generator(device="cuda").manual_seed(2027)
    batch = {"image": torch.randn(shape, generator=gen,
                                  device="cuda").to(torch.bfloat16),
             "label": torch.randint(0, RESNET_CLASSES, (RESNET_BATCH,),
                                    generator=gen, device="cuda")}
    out = {}
    states, steps = {}, {}
    for name, m in (("meshless", None), ("mesh", mesh)):
        states[name] = create_train_state(model, seed=0, input_shape=shape,
                                          tx=make_optimizer(), mesh=m)
        steps[name] = make_train_step(m, smoothing=RESNET_SMOOTHING)
        _build.reset_launches()
        states[name], metrics = steps[name](states[name], batch)
        out[name] = float(metrics["loss"])
    launches = dict(_build.LAUNCHES)   # the mesh step's
    for name in BN_KERNELS:
        if launches[name] != RESNET_NORMS:
            _fail(f"mesh ResNet-50 step: {launches[name]} {name} launches, "
                  f"not one for each of its {RESNET_NORMS} norms")
    loss_err = abs(out["mesh"] - out["meshless"]) / abs(out["meshless"])
    if not loss_err <= PARALLEL_RTOL:
        _fail(f"mesh ResNet-50 step-0 loss {out['mesh']} vs meshless "
              f"{out['meshless']}")
    whole = gather_state(states["mesh"])
    errs = {}
    for group in ("params", "batch_stats"):
        errs[group] = worst_leaf(torch, dict(flatten(getattr(whole, group))),
                                 dict(flatten(getattr(states["meshless"],
                                                      group))))
        (err, leaf), _ = errs[group]
        if not err <= PARALLEL_RTOL:
            _fail(f"mesh ResNet-50 {group} leaf {leaf} after step 0 is "
                  f"{err} from the meshless step's in relative norm")
    del whole
    ms = {}
    for name in ("meshless", "mesh"):
        states[name], ms[name] = timed_steps(torch, steps[name],
                                             states[name], batch,
                                             PARALLEL_RESNET_STEPS)
    return {"loss": out, "loss_rel_err": loss_err,
            "params_rel_err_max": errs["params"][0][0],
            "batch_stats_rel_err_max": errs["batch_stats"][0][0],
            "bit_equal": (out["mesh"] == out["meshless"]
                          and errs["params"][1] and errs["batch_stats"][1]),
            "step_ms": ms,
            "step_ms_median": {n: statistics.median(v) for n, v in ms.items()},
            "launches": launches}


def ring_hops(torch, timer) -> dict:
    """``ring_hop`` over RING_SHARDS source shards for each query shard
    (dead hops skipped by ``hop_live``) in one process on the card, bf16,
    at RING_SHAPE: causal, a RING_WINDOW window, and packed documents
    that cross shard boundaries, each against ``mha_reference`` in f32
    within TOL_BF16; then the device ms of one live hop."""
    from kubeflow_tpu_torch.ops.attention import mha_reference
    from kubeflow_tpu_torch.ops.ring import hop_live, ring_hop

    b, h, h_kv, s, d = (RING_SHAPE[k] for k in ("b", "h", "h_kv", "s", "d"))
    n, s_local = RING_SHARDS, s // RING_SHARDS
    gen = torch.Generator(device="cuda").manual_seed(2031)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for shape in ((b, h, s, d), (b, h_kv, s, d), (b, h_kv, s, d)))
    # Documents of 1000 to 3000 tokens: boundaries inside shards, and
    # documents that span a shard boundary.
    seg = torch.zeros((b, s), dtype=torch.int32, device="cuda")
    for cut in (1500, 2600, 5000, 7100):
        seg[:, cut:] += 1

    def shard(t, i, dim=2):
        return t.narrow(dim, i * s_local, s_local)

    def hop_args(i, src, causal, window, segs):
        return dict(q_index=i, src=src, s_local=s_local, scale=d ** -0.5,
                    causal=causal, window=window,
                    seg_q=None if segs is None else shard(segs, i, 1),
                    seg_k=None if segs is None else shard(segs, src, 1))

    def drive(causal, window, segs):
        outs, hops = [], 0
        for i in range(n):
            qg = shard(q, i).reshape(b, h_kv, h // h_kv, s_local, d)
            o = torch.zeros(qg.shape, dtype=torch.float32, device="cuda")
            m = torch.full(qg.shape[:-1] + (1,), -1e30, device="cuda")
            carry = (o, m, torch.zeros_like(m))

            def rng(j):
                if segs is None:
                    return None
                blk = shard(segs, j, 1)
                return [blk.amin(1).tolist(), blk.amax(1).tolist()]

            for src in range(n):
                if hop_live(i, src, s_local, causal, window, rng(i),
                            rng(src)):
                    hops += 1
                    carry = ring_hop(qg, shard(k, src), shard(v, src), carry,
                                     **hop_args(i, src, causal, window,
                                                segs))
            outs.append((carry[0] / carry[2]).reshape(b, h, s_local, d)
                        .to(torch.bfloat16))
        return torch.cat(outs, dim=2), hops

    cases = {}
    for name, causal, window, segs in (("causal", True, None, None),
                                       ("window", True, RING_WINDOW, None),
                                       ("segments", True, None, seg)):
        got, hops = drive(causal, window, segs)
        ref = mha_reference(q.float(), k.float(), v.float(), causal=causal,
                            window=window, segment_ids=segs)
        err, used = check_close(got, ref, TOL_BF16)
        if not used <= 1.0:
            _fail(f"ring hops [{name}] at {used} of the bf16 limit")
        cases[name] = {"hops": hops, "max_abs_err": err, "tol_used": used}
        del ref
    qg = shard(q, n - 1).reshape(b, h_kv, h // h_kv, s_local, d)
    o = torch.zeros(qg.shape, dtype=torch.float32, device="cuda")
    m = torch.zeros(qg.shape[:-1] + (1,), device="cuda")
    carry = (o, m, torch.ones_like(m))
    hop_ms = timer(lambda: ring_hop(qg, shard(k, 0), shard(v, 0), carry,
                                    **hop_args(n - 1, 0, True, None, None)))
    return {"shape": RING_SHAPE, "shards": n, "window": RING_WINDOW,
            "tol": TOL_BF16, "cases": cases, "hop_ms": hop_ms,
            "collectives": "held on the CPU in gloo worlds "
                           "(tests/test_torch_ring.py), not on the card"}


# mesh_ckpt phase: MESH_CKPT_STEPS steps of the checkpointed loop on the
# mesh, a save every MESH_CKPT_SAVE_EVERY, SIGTERM while step
# MESH_CKPT_PREEMPT_AT is in flight; MESH_MOE_STEPS timed MoE steps of
# each path.
MESH_CKPT_STEPS, MESH_CKPT_SAVE_EVERY, MESH_CKPT_PREEMPT_AT = 4, 2, 3
MESH_MOE_STEPS = 3


def timed_restore(torch, fn):
    """``fn()`` and its seconds, the device synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mesh_ckpt_loop(torch, mesh, root) -> dict:
    """The checkpointed loop on the mesh, preempted and resumed, against
    an uninterrupted mesh run; the launch counters zeroed just before the
    uninterrupted run and read just after the resumed one. Returns the
    readings and the preempted run's state and directory."""
    import os
    import signal
    import tempfile

    from kubeflow_tpu_torch.models import (
        build_lm,
        create_lm_state,
        make_lm_train_step,
        realign_batches,
        run_with_checkpointing,
    )
    from kubeflow_tpu_torch.models.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.models.optim import flatten
    from kubeflow_tpu_torch.ops import _build

    cfg = train_config(torch)
    gen = torch.Generator(device="cuda").manual_seed(2033)
    batches = [{"tokens": torch.randint(0, cfg.vocab,
                                        (TRAIN_BATCH, TRAIN_SEQ),
                                        device="cuda", generator=gen)}
               for _ in range(MESH_CKPT_STEPS)]
    step = make_lm_train_step(mesh, cfg=cfg)

    def fresh(seed):
        return create_lm_state(build_lm(cfg, mesh), seed=seed, mesh=mesh)

    directory = tempfile.mkdtemp(prefix="mesh_ckpt_", dir=root)
    torch.cuda.synchronize()
    _build.reset_launches()
    straight = fresh(0)
    for batch in batches:
        straight, _ = step(straight, batch)

    def preempting(stream):
        for i, batch in enumerate(stream):
            if i == MESH_CKPT_PREEMPT_AT - 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    mgr_b = CheckpointManager(directory, keep=2)
    t0 = time.perf_counter()
    state_b, rep_b = run_with_checkpointing(
        step, fresh(0), preempting(batches), mgr_b,
        save_every_steps=MESH_CKPT_SAVE_EVERY, mesh=mesh)
    wall_b = time.perf_counter() - t0
    if not (rep_b.preempted and rep_b.final_step == MESH_CKPT_PREEMPT_AT
            and mgr_b.latest_committed_step() == MESH_CKPT_PREEMPT_AT):
        _fail(f"mesh run B: preempted={rep_b.preempted} at "
              f"{rep_b.final_step}, committed {mgr_b.steps()}")
    stamped = mgr_b.step_fingerprint(MESH_CKPT_PREEMPT_AT).get("mesh")
    if stamped != list(mesh.spec.shape):
        _fail(f"the mesh run's manifest records mesh {stamped}")
    mgr_c = CheckpointManager(directory, keep=2)
    seen = {}

    def first_checked(state, batch):
        if not seen:
            seen["equal"] = states_equal(torch, state, state_b)
        return step(state, batch)

    t0 = time.perf_counter()
    state_c, rep_c = run_with_checkpointing(
        first_checked, fresh(1),
        realign_batches(batches, MESH_CKPT_PREEMPT_AT), mgr_c, mesh=mesh,
        install_signal_handler=False)
    wall_c = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    steps = MESH_CKPT_STEPS + MESH_CKPT_PREEMPT_AT + (
        MESH_CKPT_STEPS - MESH_CKPT_PREEMPT_AT)
    for name in TRAIN_KERNELS:
        if launches[name] != steps * cfg.layers:
            _fail(f"{name} launched {launches[name]} times in the mesh "
                  f"ckpt runs' {steps} steps, not {cfg.layers} per step")
    if not seen.get("equal"):
        _fail("the state the mesh resume starts from is not the saved one")
    if rep_c.resumed_from_step != MESH_CKPT_PREEMPT_AT or \
            rep_c.final_step != MESH_CKPT_STEPS or rep_c.resharded:
        _fail(f"mesh run C resumed from {rep_c.resumed_from_step} to "
              f"{rep_c.final_step}, resharded={rep_c.resharded}")
    (err, leaf), equal = worst_leaf(torch, dict(flatten(state_c.params)),
                                    dict(flatten(straight.params)))
    if not err <= PARALLEL_RTOL:
        _fail(f"the resumed mesh run's {leaf} is {err} from the "
              f"uninterrupted run's in relative norm")
    out = {"steps": MESH_CKPT_STEPS, "preempt_at": MESH_CKPT_PREEMPT_AT,
           "save_every_steps": MESH_CKPT_SAVE_EVERY,
           "saves": {"B": rep_b.saves, "C": rep_c.saves},
           "wall_s": {"B": wall_b, "C": wall_c}, "mesh": stamped,
           "restored_state_bit_equal": seen["equal"],
           "resumed_vs_straight_rel_err_max": err, "worst_leaf": leaf,
           "resumed_bit_equal": equal and states_equal(torch, state_c,
                                                        straight),
           "launches": launches}
    del state_c, straight
    return out, state_b, directory


def mesh_ckpt_restores(torch, mesh, state_b, directory, root) -> dict:
    """The mesh checkpoint into a whole template (mesh -> meshless) and,
    saved from there, onto a mesh template (meshless -> mesh), each equal
    to its source leaf by leaf; a mesh save timed alone."""
    import os
    import tempfile

    from kubeflow_tpu_torch.models import (
        build_lm,
        create_lm_state,
        gather_state,
    )
    from kubeflow_tpu_torch.models.checkpoint import (
        CheckpointManager,
        restore_checkpoint,
    )

    cfg = train_config(torch)
    like = create_lm_state(build_lm(cfg), seed=2)
    whole, whole_s = timed_restore(torch, lambda: restore_checkpoint(
        directory, like))
    if not states_equal(torch, whole, gather_state(state_b)):
        _fail("the mesh checkpoint restored whole is not the mesh state")
    whole_dir = tempfile.mkdtemp(prefix="whole_", dir=root)
    manager = CheckpointManager(whole_dir, keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    manager.save_async(7, whole)
    whole_blocking = time.perf_counter() - t0
    manager.wait()
    whole_save_s = time.perf_counter() - t0
    like = create_lm_state(build_lm(cfg, mesh), seed=3, mesh=mesh)
    onto, onto_s = timed_restore(torch, lambda: restore_checkpoint(
        whole_dir, like, mesh=mesh))
    if not states_equal(torch, gather_state(onto), whole):
        _fail("a whole checkpoint restored onto the mesh is not the state")
    del onto, whole
    mesh_dir = tempfile.mkdtemp(prefix="mesh_save_", dir=root)
    manager = CheckpointManager(mesh_dir, keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    manager.save_async(8, state_b)
    mesh_blocking = time.perf_counter() - t0
    manager.wait()
    mesh_save_s = time.perf_counter() - t0
    ckpt_bytes = os.path.getsize(os.path.join(mesh_dir, "8",
                                              "shard-00000.bin"))
    like = create_lm_state(build_lm(cfg, mesh), seed=4, mesh=mesh)
    _, mesh_restore_s = timed_restore(
        torch, lambda: manager.restore_latest_valid(like))
    return {"ckpt_bytes": ckpt_bytes,
            "mesh_save": {"blocking_ms": mesh_blocking * 1e3,
                          "save_s": mesh_save_s,
                          "gb_per_s": ckpt_bytes / mesh_save_s / 1e9},
            "mesh_restore_s": mesh_restore_s,
            "whole_save": {"blocking_ms": whole_blocking * 1e3,
                           "save_s": whole_save_s},
            "mesh_to_whole_restore_s": whole_s,
            "whole_to_mesh_restore_s": onto_s}


def mesh_moe(torch, mesh) -> dict:
    """The MoE config's step 0 on the mesh against the meshless step,
    launches counted over the mesh step alone; then MESH_MOE_STEPS timed
    steps of each."""
    from kubeflow_tpu_torch.models import (
        build_lm,
        create_lm_state,
        gather_state,
        make_lm_train_step,
    )
    from kubeflow_tpu_torch.models.optim import flatten
    from kubeflow_tpu_torch.ops import _build

    cfg = moe_config(torch)
    gen = torch.Generator(device="cuda").manual_seed(2034)
    batch = {"tokens": torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                                     device="cuda", generator=gen)}
    plain_step = make_lm_train_step(cfg=cfg)
    mesh_step = make_lm_train_step(mesh, cfg=cfg)
    plain, plain_m = plain_step(create_lm_state(build_lm(cfg), seed=0),
                                batch)
    meshed = create_lm_state(build_lm(cfg, mesh), seed=0, mesh=mesh)
    torch.cuda.synchronize()
    _build.reset_launches()
    meshed, mesh_m = mesh_step(meshed, batch)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for name in TRAIN_KERNELS:
        if launches[name] != cfg.layers:
            _fail(f"{name} launched {launches[name]} times in the mesh MoE "
                  f"step, not {cfg.layers}")
    loss, want = float(mesh_m["loss"]), float(plain_m["loss"])
    loss_err = abs(loss - want) / abs(want)
    if not loss_err <= PARALLEL_RTOL:
        _fail(f"mesh MoE step-0 loss {loss} vs meshless {want}")
    (err, leaf), equal = worst_leaf(
        torch, dict(flatten(gather_state(meshed).params)),
        dict(flatten(plain.params)))
    if not err <= PARALLEL_RTOL:
        _fail(f"mesh MoE leaf {leaf} after step 0 is {err} from the "
              f"meshless step's in relative norm")
    # A mesh of one runs no collective and the meshless step's kernels in
    # its order: step 0 is held bit for bit.
    if not (equal and loss == want):
        _fail(f"mesh MoE step 0 is not bit-equal to the meshless step "
              f"(loss {loss} vs {want}, worst leaf {leaf} at {err})")
    plain, plain_ms = timed_steps(torch, plain_step, plain, batch,
                                  MESH_MOE_STEPS)
    meshed, mesh_ms = timed_steps(torch, mesh_step, meshed, batch,
                                  MESH_MOE_STEPS)
    return {"loss": {"mesh": loss, "meshless": want},
            "loss_rel_err": loss_err, "leaf_rel_err_max": err,
            "worst_leaf": leaf, "bit_equal": equal and loss == want,
            "step_ms": {"mesh": mesh_ms, "meshless": plain_ms},
            "step_ms_median": {"mesh": statistics.median(mesh_ms[1:]),
                               "meshless": statistics.median(plain_ms[1:])},
            "launches": launches}


def mesh_ckpt_phase(torch, mesh, root) -> dict:
    """Checkpoints and MoE on the mesh of one (phase 15)."""
    loop, state_b, directory = mesh_ckpt_loop(torch, mesh, root)
    # The state and directory come from the run, not from its clock.
    # analysis: allow[det-wallclock-in-replay]
    restores = mesh_ckpt_restores(torch, mesh, state_b, directory, root)
    del state_b
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    moe = mesh_moe(torch, mesh)
    launches = {name: loop["launches"].get(name, 0)
                + moe["launches"].get(name, 0) for name in ALL_KERNELS}
    return {"phase": "mesh_ckpt", "world_size": mesh.size(mesh.axis_names),
            "loop": loop, "restores": restores, "moe": moe,
            "launches": launches}


# pipeline phase: the schedules PipelinedLM runs at pp = 1, as
# (name, PipelinedLM keywords, flash forwards a step beyond the primal's
# layers x M): remat and 1F1B recompute every block's forward in the
# backward (+ layers x M), and interleaved 1F1B also runs the forward
# units of chunk 0 to feed chunk 1 (+ layers / 2 x M).
PIPELINE_M = 4
PIPELINE_STEPS = 3
PIPELINE_SCHEDULES = (
    ("gpipe", {}, 0),
    ("gpipe_remat", {"remat": True}, 32),
    ("1f1b", {"schedule": "1f1b"}, 32),
    ("interleaved_v2", {"schedule": "interleaved", "virtual_stages": 2}, 0),
    ("1f1b_v2", {"schedule": "1f1b", "virtual_stages": 2}, 32 + 16),
)
# The engines' memory check: a toy stage of PIPELINE_TOY_LAYERS tanh
# layers at dim 1024, PIPELINE_TOY_M microbatches of 2048 rows, f32.
PIPELINE_TOY_LAYERS, PIPELINE_TOY_M, PIPELINE_TOY_ROWS = 8, 16, 2048


def pipeline_toy_peaks(torch, mesh) -> dict:
    """Step peak above what was allocated before, in bytes, of gpipe and
    1F1B on a toy stage (8 tanh layers at dim 1024) at M = 16."""
    from kubeflow_tpu_torch.parallel import gpipe, one_f_one_b, stage_stack

    gen = torch.Generator(device="cuda").manual_seed(31)
    dim = 1024
    w = torch.randn((PIPELINE_TOY_LAYERS, dim, dim), generator=gen,
                    device="cuda") * dim ** -0.5
    x = torch.randn((PIPELINE_TOY_M * PIPELINE_TOY_ROWS, dim), generator=gen,
                    device="cuda")

    def stage(p, h):
        for i in range(p.shape[0]):
            h = torch.tanh(h @ p[i])
        return h

    peaks = {}
    for name, engine in (("gpipe", gpipe), ("1f1b", one_f_one_b)):
        block = stage_stack(w, 1).clone().requires_grad_(True)
        run = engine(stage, mesh, num_microbatches=PIPELINE_TOY_M)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = run(block, x)
        grad, = torch.autograd.grad((y.float() ** 2).mean(), [block])
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        del block, y, grad
        torch.cuda.empty_cache()
    return peaks


def pipeline_phase(torch, mesh) -> dict:
    """The pipelined LM at pp = 1 on each of PIPELINE_SCHEDULES against
    the meshless step (module docstring, phase 16)."""
    from kubeflow_tpu_torch.models import (
        PipelinedLM,
        create_pp_lm_state,
        make_lm_train_step,
        make_pp_lm_train_step,
    )
    from kubeflow_tpu_torch.models.optim import flatten, tree_map_with_path
    from kubeflow_tpu_torch.models.pipeline_lm import stack_blocks
    from kubeflow_tpu_torch.ops import _build

    cfg, state, tokens = train_setup(torch)
    batch = {"tokens": tokens}
    state.tx = RecordingAdamW(torch)
    state.opt_state = state.tx.init(state.params)
    plain_step = make_lm_train_step(cfg=cfg)
    state, plain = plain_step(state, batch)
    plain_loss = float(plain["loss"])
    grads = dict(zip([path for path, _ in flatten(state.params)],
                     state.tx.grads))
    want = dict(flatten(stack_blocks(cfg, tree_map_with_path(
        lambda path, _: grads[path], state.params))))
    plain_ms = []
    state.tx = state.tx.inner
    for _ in range(PIPELINE_STEPS):
        t0 = time.perf_counter()
        state, metrics = plain_step(state, batch)
        float(metrics["loss"])
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    del state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    runs, totals = {}, {}
    per_microbatch = cfg.layers * PIPELINE_M
    for name, kw, recompute in PIPELINE_SCHEDULES:
        model = PipelinedLM(cfg, mesh, num_microbatches=PIPELINE_M, **kw)
        tx = RecordingAdamW(torch)
        pstate = create_pp_lm_state(model, seed=0, tx=tx)
        step = make_pp_lm_train_step(model)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        losses, ms = [], []
        for i in range(PIPELINE_STEPS):
            t0 = time.perf_counter()
            pstate, metrics = step(pstate, batch)
            losses.append(float(metrics["loss"]))   # syncs the step
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                step0 = dict(_build.LAUNCHES)
                got = dict(zip([p for p, _ in flatten(pstate.params)],
                               tx.grads))
                pstate.tx = tx.inner   # no host copies in the timed steps
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - base
        errs = {path: float((got[path] - want[path]).norm()
                            / want[path].norm()) for path in want}
        worst = max(errs.items(), key=lambda kv: kv[1])
        if not abs(losses[0] - plain_loss) <= TRAIN_LOSS_TOL:
            _fail(f"pipeline {name}: step-0 loss {losses[0]} vs meshless "
                  f"{plain_loss} (limit {TRAIN_LOSS_TOL})")
        if not worst[1] <= TRAIN_GRAD_TOL:
            _fail(f"pipeline {name}: step-0 gradient of {worst[0]} is "
                  f"{worst[1]} from the meshless step's in relative norm "
                  f"(limit {TRAIN_GRAD_TOL})")
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            _fail(f"pipeline {name}: the loss did not fall: {losses}")
        reckoned = {"flash_attention": per_microbatch + recompute,
                    "flash_dq": per_microbatch, "flash_dkv": per_microbatch}
        for kernel, n in reckoned.items():
            if step0.get(kernel, 0) != n or launches.get(
                    kernel, 0) != n * PIPELINE_STEPS:
                _fail(f"pipeline {name}: {kernel} launched "
                      f"{step0.get(kernel, 0)} times in step 0 and "
                      f"{launches.get(kernel, 0)} in {PIPELINE_STEPS} "
                      f"steps, not {n} a step")
        for kernel in ALL_KERNELS:
            totals[kernel] = totals.get(kernel, 0) + launches.get(kernel, 0)
        runs[name] = {"losses": losses, "step_ms": ms,
                      "step_ms_after_first": statistics.median(ms[1:]),
                      "loss_abs_err": abs(losses[0] - plain_loss),
                      "grad_rel_err_max": worst[1],
                      "grad_rel_err_worst_leaf": worst[0],
                      "launches_per_step": reckoned,
                      "step_peak_bytes": peak}
        del pstate, step, tx, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    peaks = pipeline_toy_peaks(torch, mesh)
    if not peaks["1f1b"] < peaks["gpipe"]:
        _fail(f"1F1B's toy step peak {peaks['1f1b']} bytes is not below "
              f"gpipe's {peaks['gpipe']} at M={PIPELINE_TOY_M}")
    return {"phase": "pipeline", "microbatches": PIPELINE_M,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "meshless": {"loss": plain_loss, "step_ms": plain_ms,
                         "step_ms_after_first": statistics.median(
                             plain_ms[1:])},
            "schedules": runs, "toy_step_peak_bytes": peaks,
            "launches": totals, "loss_tol": TRAIN_LOSS_TOL,
            "grad_tol": TRAIN_GRAD_TOL}


def parallel_phase(torch, timer, root) -> tuple:
    """The world from the platform env (a single replica: none), a mesh
    of one over the card, the LM and ResNet-50 steps on it against the
    meshless steps, the ring's hops at full width; then, on the same
    world, the mesh_ckpt, pipeline and hooks phases. Returns the four
    phases' lines."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import (
        MeshSpec,
        initialize_from_env,
        make_mesh,
        slice_env_for_rank,
    )

    denv = initialize_from_env(slice_env_for_rank("smoke", "default", 0, 1))
    if dist.is_initialized():
        _fail("initialize_from_env formed a world for a single replica")
    mesh = make_mesh(MeshSpec())
    world = {"backend": dist.get_backend(),
             "world_size": dist.get_world_size(), "mesh_shape": mesh.shape,
             "device": str(mesh.device), "multihost": denv.is_multihost}
    print(json.dumps({"phase": "parallel_world", **world}), flush=True)
    lm = parallel_lm(torch, mesh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resnet = parallel_resnet(torch, mesh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ring = ring_hops(torch, timer)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mesh_ckpt = mesh_ckpt_phase(torch, mesh, root)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pipeline = pipeline_phase(torch, mesh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    hooks = hooks_phase(torch, mesh, resnet, root)
    dist.destroy_process_group()
    launches = {name: lm["launches"].get(name, 0)
                + resnet["launches"].get(name, 0) for name in ALL_KERNELS}
    return ({"phase": "parallel", "world": world, "rtol": PARALLEL_RTOL,
             "lm": lm, "resnet": resnet, "ring": ring,
             "launches": launches}, mesh_ckpt, pipeline, hooks)


# hooks phase: the train config through run_with_checkpointing with the
# train loop's hooks (run on the parallel phase's world of one, before it
# ends, for its ResNet-50 mesh step). A critical alert fires after step
# HOOKS_EDGE_AFTER, which tightens the cadence of HOOKS_SAVE_EVERY steps
# x HOOKS_TIGHTEN to every 2 steps; SIGTERM arrives while step
# HOOKS_PREEMPT_AT is in flight, and a fresh state resumes through step
# HOOKS_STEPS.
HOOKS_STEPS, HOOKS_SAVE_EVERY, HOOKS_TIGHTEN = 6, 8, 0.25
HOOKS_EDGE_AFTER, HOOKS_PREEMPT_AT = 2, 4
# Saves: the tightened cadence at step 2, the grace save at the SIGTERM
# (step 4); after the resume the tightened cadence again at step 6.
HOOKS_SAVES = ([2, 4], [6])
HOOKS_PLAIN_STEPS = 6


class RecordingApi:
    """A stand-in for the Kubernetes API that records the merge patches
    the goodput publisher sends."""

    def __init__(self):
        self.patches = []  # analysis: allow[py-unbounded-deque]

    def patch_merge(self, api_version, kind, name, patch, namespace=None):
        self.patches.append((api_version, kind, name, namespace, patch))
        return patch


class ExitRecording:
    """The goodput publisher with the summaries it was flushed with at
    each run's exit kept (the loop calls ``flush`` there)."""

    def __init__(self, publisher):
        self.publisher = publisher
        self.exits = []  # analysis: allow[py-unbounded-deque]

    def __call__(self, summary):
        self.publisher(summary)

    def flush(self, summary):
        self.exits.append(summary)
        self.publisher.flush(summary)


def hooks_phase(torch, mesh, parallel_resnet_reading, root) -> dict:
    """The hooked checkpointed loop at the train config (module comment
    above), with the launch counters zeroed just before the first run
    and read just after the second; the hooked and the plain step's
    times; then the ResNet-50 mesh step at fsdp = 1 against the parallel
    phase's reading."""
    import os
    import signal
    import tempfile

    from kubeflow_tpu_torch import topology
    from kubeflow_tpu_torch.autopilot import (
        ActuationGuard,
        CheckpointCadenceActuator,
    )
    from kubeflow_tpu_torch.models import (
        build_lm,
        create_lm_state,
        make_lm_train_step,
        realign_batches,
        run_steps,
        run_with_checkpointing,
    )
    from kubeflow_tpu_torch.models.checkpoint import CheckpointManager
    from kubeflow_tpu_torch.models.transformer import (
        train_flops_per_sequence,
    )
    from kubeflow_tpu_torch.obs import (
        GoodputAnnotationPublisher,
        GoodputMeter,
        StepTelemetry,
    )
    from kubeflow_tpu_torch.ops import _build

    cfg = train_config(torch)
    flops = train_flops_per_sequence(cfg, TRAIN_SEQ)
    gen = torch.Generator(device="cuda").manual_seed(2031)
    batches = [{"tokens": torch.randint(0, cfg.vocab,
                                        (TRAIN_BATCH, TRAIN_SEQ),
                                        device="cuda", generator=gen)}
               for _ in range(HOOKS_STEPS)]
    step = make_lm_train_step(cfg=cfg)
    telemetry = StepTelemetry(flops_per_example=flops)
    meter = GoodputMeter()
    api = RecordingApi()
    publisher = ExitRecording(GoodputAnnotationPublisher(api, "default",
                                                         "smoke"))
    actuator = CheckpointCadenceActuator(
        tighten_factor=HOOKS_TIGHTEN,
        guard=ActuationGuard(min_interval_s=0.0))
    fired = {}

    def edge_after(state, batch):
        state, metrics = step(state, batch)
        if state.step == HOOKS_EDGE_AFTER and not fired:
            fired["at"] = state.step
            actuator.on_transition({
                "kind": "slo_alert", "slo": "train-goodput", "speed": "fast",
                "severity": "critical", "from": "pending", "to": "firing",
                "burn": 20.0, "at": time.time(), "namespace": None})
        return state, metrics

    def preempting(stream):
        for i, batch in enumerate(stream):
            if i == HOOKS_PREEMPT_AT - 1:   # step HOOKS_PREEMPT_AT in flight
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    directory = tempfile.mkdtemp(prefix="hooks_", dir=root)
    hooks = dict(save_every_steps=HOOKS_SAVE_EVERY, telemetry=telemetry,
                 goodput_publish=publisher, cadence_signal=actuator.factor)
    torch.cuda.synchronize()
    _build.reset_launches()
    manager = CheckpointManager(directory, keep=3)
    state, first = run_with_checkpointing(
        edge_after, create_lm_state(build_lm(cfg), seed=0),
        preempting(batches), manager, goodput=meter, **hooks)
    saves_first = manager.steps()
    snapshot = meter.snapshot()
    del state
    torch.cuda.empty_cache()
    resumed_meter = GoodputMeter.from_snapshot(snapshot)
    manager = CheckpointManager(directory, keep=3)
    state, second = run_with_checkpointing(
        edge_after, create_lm_state(build_lm(cfg), seed=1),
        realign_batches(batches, HOOKS_PREEMPT_AT), manager,
        goodput=resumed_meter, **hooks)
    launches = dict(_build.LAUNCHES)
    saves_second = [s for s in manager.steps() if s > HOOKS_PREEMPT_AT]
    if not (first.preempted and first.final_step == HOOKS_PREEMPT_AT
            and second.resumed_from_step == HOOKS_PREEMPT_AT
            and second.final_step == HOOKS_STEPS):
        _fail(f"hooked runs: {vars(first)} then {vars(second)}")
    if (saves_first, saves_second) != HOOKS_SAVES or fired != {
            "at": HOOKS_EDGE_AFTER}:
        _fail(f"saves {saves_first} and {saves_second} after the edge at "
              f"{fired}, not {HOOKS_SAVES} (a cadence of "
              f"{HOOKS_SAVE_EVERY} x {HOOKS_TIGHTEN})")
    records = list(telemetry.records)
    if [r["step"] for r in records] != list(range(HOOKS_STEPS)):
        _fail(f"telemetry recorded steps {[r['step'] for r in records]}")
    peak = topology.PEAK_BF16_FLOPS[torch.cuda.get_device_name(0)]
    if telemetry.peak_flops != peak:
        _fail(f"telemetry's peak {telemetry.peak_flops} is not the card's")
    for r in records:
        want = TRAIN_BATCH * flops / (r["step_time_s"] * peak)
        if not abs(r["mfu"] - want) <= 1e-6 + 1e-5 * want:
            _fail(f"step {r['step']}: mfu {r['mfu']}, reckoned {want}")
    downtime = resumed_meter.downtime_s
    goodput = resumed_meter.summary()
    ratio = goodput["goodput_ratio"]
    if not (downtime.get("restore", 0.0) > 0.0 and "gap" in downtime
            and resumed_meter.steps == HOOKS_STEPS and 0.0 < ratio <= 1.0):
        _fail(f"goodput: {resumed_meter.summary()}")
    annotation = api.patches[-1][-1]["metadata"]["annotations"][
        "obs.kubeflow-tpu.org/goodput-ratio"]
    exits = publisher.exits
    if len(exits) != 2 or annotation != (
            f"{exits[-1]['goodput_ratio']:.4f}") or not abs(
            float(annotation) - ratio) <= 1e-4:
        _fail(f"the final annotation {annotation} is not the meter's ratio "
              f"{ratio} (flushed at exit: {exits})")
    for name in TRAIN_KERNELS:
        if launches[name] != HOOKS_STEPS * cfg.layers:
            _fail(f"{name} launched {launches[name]} times in "
                  f"{HOOKS_STEPS} hooked steps, not {cfg.layers} a step")
    hooked_ms = [r["step_time_s"] * 1e3 for r in records]
    # The same state through plain run_steps: no hook, no per-step sync.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = run_steps(step, state, [batches[-1]] * HOOKS_PLAIN_STEPS)
    float(metrics["loss"])
    plain_ms = (time.perf_counter() - t0) * 1e3 / HOOKS_PLAIN_STEPS
    del state
    torch.cuda.empty_cache()
    resnet = hooks_resnet(torch, mesh, parallel_resnet_reading)
    steady = statistics.median(hooked_ms[1:])
    return {
        "phase": "hooks", "steps": HOOKS_STEPS,
        "flops_per_sequence": flops, "peak_flops": peak,
        "saves": [saves_first, saves_second], "edge_after": fired["at"],
        "reports": [vars(first), vars(second)],
        "telemetry": telemetry.summary(),
        "mfu": [r["mfu"] for r in records],
        "goodput": goodput, "annotation": annotation,
        "publishes": publisher.publisher.publishes,
        "hooked_step_ms": hooked_ms, "hooked_step_ms_median": steady,
        "plain_step_ms": plain_ms,
        "hooked_over_plain": steady / plain_ms,
        "launches": launches, "resnet": resnet,
    }


def hooks_resnet(torch, mesh, reading) -> dict:
    """ResNet-50 at the resnet phase's shape: one mesh step at fsdp = 1
    (the model's per-block gathers pass the weights through) from seed 0
    on the parallel phase's batch, bit-equal to that phase's mesh and
    meshless readings."""
    from kubeflow_tpu_torch.models import (
        create_train_state,
        make_optimizer,
        make_train_step,
        resnet50,
    )

    shape = (RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3)
    gen = torch.Generator(device="cuda").manual_seed(2027)
    batch = {"image": torch.randn(shape, generator=gen,
                                  device="cuda").to(torch.bfloat16),
             "label": torch.randint(0, RESNET_CLASSES, (RESNET_BATCH,),
                                    generator=gen, device="cuda")}
    state = create_train_state(resnet50(num_classes=RESNET_CLASSES), seed=0,
                               input_shape=shape, tx=make_optimizer(),
                               mesh=mesh)
    _, metrics = make_train_step(mesh, smoothing=RESNET_SMOOTHING)(state,
                                                                   batch)
    loss = float(metrics["loss"])
    if not (reading["bit_equal"] and loss == reading["loss"]["mesh"]
            == reading["loss"]["meshless"]):
        _fail(f"ResNet-50 mesh step at fsdp = 1: loss {loss} against the "
              f"parallel phase's {reading['loss']} "
              f"(bit-equal there: {reading['bit_equal']})")
    return {"loss": loss, "bit_equal": True, "fsdp": mesh.shape["fsdp"]}


# bench phase: ``python -m kubeflow_tpu_torch.bench`` as a user runs it,
# every section at full width, in a process of its own.
BENCH_TIMEOUT_S = 600


def bench_phase(torch) -> dict:
    """The port's bench in a subprocess: one JSON line, every record
    valid, no section failed, the card, torch and CUDA in the
    provenance, no baseline; the kernels' launches counted in the child
    and printed by it."""
    import os

    from kubeflow_tpu_torch.obs import perfwatch
    from kubeflow_tpu_torch.ops import _build

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KFT_BENCH_")}
    log = _build.BUILD_DIR / "bench_stderr.log"
    t0 = time.perf_counter()
    with open(log, "w") as err:
        proc = subprocess.run(
            [sys.executable, "-m", "kubeflow_tpu_torch.bench"], env=env,
            stdout=subprocess.PIPE, stderr=err, text=True,
            timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    if proc.returncode != 0 or len(lines) != 1:
        _fail(f"the bench exited {proc.returncode} with {len(lines)} lines:"
              f" {proc.stdout[-2000:]}\n{log.read_text()[-4000:]}")
    doc = json.loads(lines[0])
    extras = doc.get("extra_metrics") or []
    errors = [e for e in extras if e.get("metric") == "bench_extra_error"]
    if errors:
        _fail(f"bench sections failed: {errors}")
    records = perfwatch.records_from_full(doc)
    if len(records) != 1 + len(extras):
        _fail(f"{len(records)} bench records for {1 + len(extras)} sections")
    for record in records:
        problems = perfwatch.validate_record(record)
        prov = record["provenance"]
        if problems or prov["platform"] != "gpu" or prov["device"] != (
                torch.cuda.get_device_name(0)) or prov["torch"] != (
                torch.__version__) or prov["cuda"] != torch.version.cuda:
            _fail(f"bench record {record['section']}: {problems} {prov}")
        if record.get("vs_baseline") is not None:
            _fail(f"bench record {record['section']} has a baseline")
    launches = doc["kernel_launches"]
    missing = [name for name in SERVE_KERNELS + TRAIN_KERNELS
               if not launches.get(name)]
    if missing:
        _fail(f"the bench launched no {missing}: {launches}")
    return {"phase": "bench", "wall_s": wall,
            "values": {r["section"]: r["value"] for r in records},
            "units": {r["section"]: r["unit"] for r in records},
            "step_ms": {r["section"]: r.get("step_ms",
                                            r.get("decode_step_ms"))
                        for r in records},
            "resnet_mfu": doc.get("mfu"),
            "vs_measured_ref": doc.get("vs_measured_ref"),
            "noise": doc["noise"]["grade"], "provenance": doc["provenance"],
            "launches": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from kubeflow_tpu_torch import kernels_available
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})",
              file=sys.stderr)
        return 2
    if not kernels_available():
        print("chip_smoke: the kernels need a compute-capability 9.0 card",
              file=sys.stderr)
        return 2
    from kubeflow_tpu_torch import topology

    global BF16_FLOPS_PER_S
    BF16_FLOPS_PER_S = topology.PEAK_BF16_FLOPS.get(
        torch.cuda.get_device_name(0))
    if BF16_FLOPS_PER_S is None:
        print("chip_smoke: no dense bf16 peak for "
              f"{torch.cuda.get_device_name(0)} in the port's table",
              file=sys.stderr)
        return 2
    from kubeflow_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    timer = Timer(torch)
    cases = kernel_phase(torch, timer)
    print(json.dumps({"phase": "kernels", "build_s": build_s,
                      "cases": cases}), flush=True)
    cfg = flagship(torch)
    serve, params, outputs = serve_phase(torch, cfg)
    print(json.dumps(serve), flush=True)
    spec = spec_phase(torch, cfg, params)
    print(json.dumps(spec), flush=True)
    spec_serve = spec_serve_phase(torch, cfg, params)
    print(json.dumps(spec_serve), flush=True)
    torch.cuda.empty_cache()
    requests = serve_requests(torch, cfg)
    int8, qparams = int8_phase(torch, cfg, params, requests)
    print(json.dumps(int8), flush=True)
    print(json.dumps(gateway_phase(torch, cfg, params, requests, outputs)),
          flush=True)
    print(json.dumps(trace_phase(torch, cfg, params)), flush=True)
    print(json.dumps({**trace_phase(torch, cfg, qparams),
                      "phase": "trace_int8"}), flush=True)
    del qparams
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    train = train_phase(torch)
    print(json.dumps(train), flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    import shutil
    import tempfile

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt_smoke_", dir=_build.BUILD_DIR)
    try:
        ckpt, directory = ckpt_phase(torch, root)
        print(json.dumps(ckpt), flush=True)
        torch.cuda.empty_cache()
        pod = pod_ckpt_check(torch, directory)
        print(json.dumps(pod), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    long = long_phase(torch)
    print(json.dumps(long), flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="resnet_smoke_", dir=_build.BUILD_DIR)
    try:
        resnet = resnet_phase(torch, root)
        print(json.dumps(resnet), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    moe = moe_phase(torch, timer)
    print(json.dumps(moe), flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="mesh_ckpt_smoke_", dir=_build.BUILD_DIR)
    try:
        parallel, mesh_ckpt, pipeline, hooks = parallel_phase(torch, timer,
                                                              root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(parallel), flush=True)
    print(json.dumps(mesh_ckpt), flush=True)
    print(json.dumps(pipeline), flush=True)
    print(json.dumps(hooks), flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    bench = bench_phase(torch)
    print(json.dumps(bench), flush=True)
    main_case = {"gemv": "tied_head", "qkv_rope": "flagship",
                 "decode_attention": "serve_shape",
                 "flash_attention": "causal", "flash_dq": "train_causal",
                 "flash_dkv": "train_causal", "split3": "lm_head_grad",
                 **{name: "stem" for name in BN_KERNELS}}
    # Launches from the phase that runs each kernel: the serve run for
    # the serving kernels, the train run for the backward kernels and
    # the split, the resnet phase's steps for the BatchNorm kernels
    # (``replaces`` None: these port no TPU kernel). The
    # flash forward runs on both: ``launches`` is the serve run's,
    # ``train_launches`` the train run's; ``int8_launches`` are the int8
    # phase's engine run's (int8 weights: every gemv and qkv_rope launch
    # there takes an int8 weight); ``ckpt_launches`` the ckpt phase's
    # three runs'; ``pod_ckpt_launches`` the checkpoint-restored pod's
    # own, counted in its process over its two requests;
    # ``long_launches`` the long phase's three runs'; ``spec_launches``
    # the spec phase's four speculative runs', ``spec_serve_launches``
    # the speculative engine run's, ``moe_launches`` the moe phase's two
    # training runs' and its fallback engine run's, ``parallel_launches``
    # the parallel phase's mesh LM steps', ``mesh_ckpt_launches`` the
    # mesh_ckpt phase's checkpointed mesh runs' and mesh MoE step's,
    # ``pipeline_launches`` the pipeline phase's steps of its five
    # schedules, ``hooks_launches`` the hooks phase's two checkpointed
    # runs', ``bench_launches`` the bench's, counted in its process.
    launches = {**serve["launches"], "flash_dq": train["launches"]["flash_dq"],
                "flash_dkv": train["launches"]["flash_dkv"],
                "split3": train["launches"]["split3"],
                **{name: resnet["launches"][name] for name in BN_KERNELS}}
    meta = {
        "flash_attention": ("kubeflow_tpu_torch/csrc/flash_fwd.cu",
                            "kubeflow_tpu/ops/attention.py:158"),
        "flash_dq": ("kubeflow_tpu_torch/csrc/flash_bwd.cu",
                     "kubeflow_tpu/ops/attention.py:328"),
        "flash_dkv": ("kubeflow_tpu_torch/csrc/flash_bwd.cu",
                      "kubeflow_tpu/ops/attention.py:374"),
        "gemv": ("kubeflow_tpu_torch/csrc/gemv.cu",
                 "kubeflow_tpu/ops/gemv.py:51"),
        "qkv_rope": ("kubeflow_tpu_torch/csrc/decode_qkv.cu",
                     "kubeflow_tpu/ops/decode_qkv.py:64"),
        "decode_attention": ("kubeflow_tpu_torch/csrc/decode_attention.cu",
                             "kubeflow_tpu/ops/decode_attention.py:65"),
        "split3": ("kubeflow_tpu_torch/csrc/split3.cu", None),
        **{name: ("kubeflow_tpu_torch/csrc/batch_norm.cu", None)
           for name in BN_KERNELS},
    }
    summary = []
    for name, (source, replaces) in meta.items():
        case = next(c for c in cases[name] if c["case"] == main_case[name])
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": case["ms"], "kernel_ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            "case": case["case"],
            "int8_launches": int8["launches"][name],
            "train_launches": train["launches"][name],
            "ckpt_launches": ckpt["launches"][name],
            "pod_ckpt_launches": pod["launches"][name],
            "long_launches": long["launches"][name],
            "spec_launches": spec["launches"][name],
            "spec_serve_launches": spec_serve["launches"][name],
            "moe_launches": moe["launches"][name],
            "parallel_launches": parallel["launches"][name],
            "mesh_ckpt_launches": mesh_ckpt["launches"][name],
            "pipeline_launches": pipeline["launches"][name],
            "hooks_launches": hooks["launches"][name],
            "bench_launches": bench["launches"][name]})
    print(json.dumps({"kernels": summary}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

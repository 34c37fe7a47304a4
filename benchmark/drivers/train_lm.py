"""A closed training loop of the LM on packed documents.

Set-up builds one train state (the program's ``make_lm_train_step``
with AdamW as the configuration states) on weights the benchmark draws
from the seed, and drives it through the first ``compared_steps`` steps
on the window's own feed: these warm every shape and are what the
reference follows. The window then runs steps on the same state until
``--seconds`` have passed, each step's loss read back one step late so
the card never waits for the host; its rate is every token over every
second of the window. With ``--trace 1`` a sub-window of ``trace_steps``
steps, ``trace_after_s`` into the window, is profiled.

After the window the state is freed and the plain reference runs the
compared steps from the same weights and batches.
"""

from __future__ import annotations

import time

import torch

from benchmark import compare, counts, harness, traffic, weights
from benchmark.drivers import free, memory_peak, sync_fn
from benchmark.reference import Products, exact_f32
from benchmark.reference import lm as ref_lm


class Feed:
    """``pool_batches`` packed batches on the device: segment ids from
    the mix, token ids from the seed; step ``i`` takes batch ``i`` of
    the pool, round and round."""

    def __init__(self, mix: dict, cfg: dict, seed: int, device):
        seg = traffic.packed_batches(mix, seed, mix["pool_batches"])
        self.pairs = [sum(counts.live_pairs(traffic.segment_lengths(row))
                          for row in b) for b in seg]
        self.seg = torch.from_numpy(seg).to(device)
        self.tokens = torch.randint(
            0, cfg["vocab"], self.seg.shape,
            generator=weights.generator(seed + 2, device), device=device)

    def __len__(self) -> int:
        return self.seg.shape[0]

    def __call__(self, i: int) -> dict:
        i %= len(self)
        return {"tokens": self.tokens[i], "segment_ids": self.seg[i]}


def lm_config(cfg: dict):
    from kubeflow_tpu_torch.models.transformer import LMConfig

    return LMConfig(vocab=cfg["vocab"], layers=cfg["layers"], dim=cfg["dim"],
                    heads=cfg["heads"], kv_heads=cfg["kv_heads"],
                    mlp_ratio=cfg["mlp_ratio"],
                    dtype=getattr(torch, cfg["train"]["compute_dtype"]))


def build(cfg: dict, seed: int, device):
    """The program's train state and step, on the seed's weights."""
    from kubeflow_tpu_torch.models.optim import AdamW
    from kubeflow_tpu_torch.models.train import TrainState
    from kubeflow_tpu_torch.models.transformer import (
        build_lm,
        make_lm_train_step,
    )

    lm_cfg = lm_config(cfg)
    opt = cfg["train"]["optimizer"]
    tx = AdamW(opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
               weight_decay=opt["weight_decay"],
               mu_dtype=getattr(torch, opt["mu_dtype"]))
    flat = weights.lm(cfg, seed, device, torch.float32)
    params = weights.nest({k: v.requires_grad_() for k, v in flat.items()})
    state = TrainState(step=0, params=params, opt_state=tx.init(params),
                       tx=tx, apply_fn=build_lm(lm_cfg))
    return state, make_lm_train_step(cfg=lm_cfg)


def run(ctx: harness.Context, wrap_step=None,
        window: bool = True) -> harness.Outcome:
    """``wrap_step`` (tests) wraps the program's step; ``window=False``
    (the readings tool) skips the window: set-up, its compared steps
    and the reference alone."""
    cfg, mix, device = ctx.config, ctx.mix, ctx.device
    sync = sync_fn(device)
    feed = Feed(mix, cfg, ctx.seed, device)
    state, step = build(cfg, ctx.seed, device)
    if wrap_step is not None:
        step = wrap_step(step)
    b2 = cfg["train"]["optimizer"]["b2"]
    compared = mix["compared_steps"]
    losses, grad = [], None
    for i in range(compared):
        state, out = step(state, feed(i))
        losses.append(float(out["loss"]))
        if i == 0:
            # The gradient the optimizer got, from its state: nu = (1 -
            # b2) g^2 after one step.
            grad = {k: (float(v.double().sum()) / (1 - b2)) ** 0.5
                    for k, v in weights.flatten(
                        vars(state.opt_state)["nu"]).items()}
    start = weights.lm(cfg, ctx.seed, device, torch.float32)
    now = weights.flatten(state.params)
    change = compare.norms({k: now[k].detach() - start[k] for k in start})
    del start, now

    sync()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.setup_start
    steps, pending, i = 0, None, compared
    reading = harness.Reading()
    traced: list[int] = []
    while window:
        if (ctx.trace and reading.trace is None
                and time.perf_counter() - t0 >= mix["trace_after_s"]):
            reading.trace = _traced(step, state, feed, i,
                                    mix["trace_steps"], sync)
            traced = list(range(i, i + mix["trace_steps"]))
            i += len(traced)
            steps += len(traced)
            continue
        state, out = step(state, feed(i))
        if pending is not None:
            float(pending)
        pending = out["loss"]
        i, steps = i + 1, steps + 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    if pending is not None:
        float(pending)
    seconds = time.perf_counter() - t0
    peak = memory_peak(device)

    batch, seq = mix["batch"], mix["seq"]
    reading.counts = {
        "config": cfg, "batch": batch, "seq": seq,
        "traced_pairs": [feed.pairs[j % len(feed)] for j in traced]}
    if reading.trace is not None:
        reading.trace = reading.trace.trace
    del state, step
    free(device)
    ref_losses, ref_grad, ref_change = reference(ctx, feed, Products())
    checks, notes = compare.training_checks(
        ctx.limits, losses, ref_losses, grad, ref_grad, change, ref_change)
    return harness.Outcome(
        end_to_end={"train_tokens_per_s": steps * batch * seq / seconds,
                    "setup_s": setup_s},
        attempted=steps, failed=0, checks=checks, memory_peak_bytes=peak,
        reading=reading if ctx.trace else None, notes=notes)


def _traced(step, state, feed, first: int, count: int, sync):
    from benchmark.tracing import Window

    with Window(sync) as window:
        for j in range(first, first + count):
            state, out = step(state, feed(j))
    float(out["loss"])
    return window


def reference(ctx: harness.Context, feed: Feed, prod: Products):
    """(losses, first gradient norms, change norms) of the plain
    reference over the compared steps."""
    cfg, device = ctx.config, ctx.device
    batches = [(feed(i)["tokens"], feed(i)["segment_ids"])
               for i in range(ctx.mix["compared_steps"])]
    with exact_f32():
        w = weights.lm(cfg, ctx.seed, device, torch.float32)
        start = {k: v.clone() for k, v in w.items()}
        losses, first = ref_lm.train(w, cfg, batches,
                                     cfg["train"]["optimizer"], prod,
                                     rows=ctx.mix["reference_rows"])
        change = compare.norms({k: w[k] - start[k] for k in w})
    return losses, compare.norms(first), change


def control(ctx: harness.Context) -> tuple[list, dict]:
    """The fp8 reference in the program's place, read as the program
    is: (checks, notes) against the f32 reference."""
    feed = Feed(ctx.mix, ctx.config, ctx.seed, ctx.device)
    low = reference(ctx, feed, Products(fp8=True))
    ref = reference(ctx, feed, Products())
    return compare.training_checks(ctx.limits, low[0], ref[0], low[1],
                                   ref[1], low[2], ref[2])

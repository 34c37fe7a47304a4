"""A closed training loop of the image model.

Set-up builds one train state (the program's ``make_train_step`` with
the configuration's Nesterov SGD and label smoothing) on weights the
benchmark draws from the seed, and drives it through the first
``compared_steps`` steps on the window's own feed: these warm every
shape and are what the reference follows. The window then runs steps
until ``--seconds`` have passed, each step's loss read back one step
late; its rate is every image over every second of the window. With
``--trace 1`` a sub-window of ``trace_steps`` steps, ``trace_after_s``
into the window, is profiled.

After the window the state is freed and the plain reference runs the
compared steps from the same weights and batches.
"""

from __future__ import annotations

import time

import torch

from benchmark import compare, harness, weights
from benchmark.drivers import free, memory_peak, sync_fn
from benchmark.reference import Products, exact_f32
from benchmark.reference import resnet as ref_resnet


class Feed:
    """``pool_batches`` batches of ``batch`` images (N, H, W, C) in the
    configuration's image dtype and their labels, drawn on the device
    from the seed; step ``i`` takes batch ``i`` of the pool, round and
    round."""

    def __init__(self, mix: dict, cfg: dict, seed: int, device):
        size, n = cfg["image_size"], mix["batch"]
        gen = weights.generator(seed + 2, device)
        shape = (mix["pool_batches"], n, size, size, cfg["channels"])
        self.images = torch.randn(shape, generator=gen, device=device,
                                  dtype=torch.float32).to(
            getattr(torch, cfg["image_dtype"]))
        self.labels = torch.randint(0, cfg["classes"], shape[:2],
                                    generator=gen, device=device)

    def __len__(self) -> int:
        return self.images.shape[0]

    def __call__(self, i: int) -> dict:
        i %= len(self)
        return {"image": self.images[i], "label": self.labels[i]}


def build(cfg: dict, seed: int, device):
    """The program's train state and step, on the seed's weights."""
    from kubeflow_tpu_torch.models.optim import make_optimizer
    from kubeflow_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from kubeflow_tpu_torch.models.train import TrainState, make_train_step

    model = ResNet(cfg["stage_sizes"], BottleneckBlock,
                   num_classes=cfg["classes"], width=cfg["width"],
                   dtype=getattr(torch, cfg["compute_dtype"]))
    opt = cfg["optimizer"]
    tx = make_optimizer(opt["lr"], opt["momentum"], opt["weight_decay"])
    flat, stats = weights.resnet(cfg, seed, device)
    params = weights.nest({k: v.requires_grad_() for k, v in flat.items()})
    state = TrainState(step=0, params=params, opt_state=tx.init(params),
                       tx=tx, apply_fn=model, batch_stats=weights.nest(stats))
    return state, make_train_step(smoothing=cfg["label_smoothing"])


def first_gradient(cfg: dict, state, start: dict) -> dict:
    """The gradient the optimizer got at the first step, from its state:
    the trace after one step is g + wd * p0 on leaves of ndim > 1, g on
    the rest."""
    wd = cfg["optimizer"]["weight_decay"]
    trace = weights.flatten(state.opt_state[1][0].trace)
    return compare.norms({k: t - wd * start[k] if t.ndim > 1 else t
                          for k, t in trace.items()})


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
    compared = mix["compared_steps"]
    losses, grad = [], None
    for i in range(compared):
        state, out = step(state, feed(i))
        losses.append(float(out["loss"]))
        if i == 0:
            start, _ = weights.resnet(cfg, ctx.seed, device)
            grad = first_gradient(cfg, state, start)
            del start
    start, _ = weights.resnet(cfg, ctx.seed, device)
    now = weights.flatten(state.params)
    change = compare.norms({k: now[k].detach() - start[k] for k in start})
    del start, now

    sync()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.setup_start
    steps, pending, i = 0, None, compared
    reading = harness.Reading()
    while window:
        if (ctx.trace and reading.trace is None
                and time.perf_counter() - t0 >= mix["trace_after_s"]):
            reading.trace = _traced(step, state, feed, i,
                                    mix["trace_steps"], sync)
            reading.counts["traced_images"] = (mix["trace_steps"]
                                               * mix["batch"])
            i += mix["trace_steps"]
            steps += mix["trace_steps"]
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
    images = steps * mix["batch"]
    reading.counts["config"] = cfg
    if reading.trace is not None:
        reading.trace = reading.trace.trace
    del state, step
    free(device)
    ref_losses, ref_grad, ref_change = reference(ctx, feed, Products())
    checks, notes = compare.training_checks(
        ctx.limits, losses, ref_losses, grad, ref_grad, change, ref_change)
    return harness.Outcome(
        end_to_end={"images_per_s": images / seconds, "setup_s": setup_s},
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
    batches = [(feed(i)["image"], feed(i)["label"])
               for i in range(ctx.mix["compared_steps"])]
    with exact_f32():
        p, stats = weights.resnet(cfg, ctx.seed, device)
        start = {k: v.clone() for k, v in p.items()}
        losses, first = ref_resnet.train(p, stats, cfg, batches,
                                         cfg["optimizer"], prod)
        change = compare.norms({k: p[k] - start[k] for k in p})
    return losses, compare.norms(first), change


def control(ctx: harness.Context) -> tuple[list, dict]:
    """The fp8 reference in the program's place, read as the program
    is: (checks, notes) against the f32 reference."""
    feed = Feed(ctx.mix, ctx.config, ctx.seed, ctx.device)
    low = reference(ctx, feed, Products(fp8=True))
    ref = reference(ctx, feed, Products())
    return compare.training_checks(ctx.limits, low[0], ref[0], low[1],
                                   ref[1], low[2], ref[2])

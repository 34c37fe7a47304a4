"""The image model's closed training loop on a data-parallel mesh: one
process a card (``benchmark.world``), the mix's ``batch`` rows a card.

Set-up, on every rank: the weights the one-card driver draws from the
seed, laid on a dp mesh over every rank (the program's ``make_mesh`` and
``shard_state``), and its mesh step (``make_train_step(mesh=)``: each
rank takes its rows of the whole batch, every BatchNorm's moments and
every gradient all-reduced over the ranks), driven through the first
``compared_steps`` steps on the window's own feed. In the window, rank
0's clock decides, through the world's gloo group, when the traced
sub-window opens and when the window closes, so every rank runs the
same steps. The rate is every rank's images over rank 0's window.

After the window the state is freed and the plain reference runs the
compared steps from the same weights and batches on four plain ranks:
each its rows, the moments and the gradients summed over the NCCL
world, in f32.
"""

from __future__ import annotations

import time

import torch.distributed as dist

from benchmark import compare, harness, weights
from benchmark.drivers import free, memory_peak, sync_fn
from benchmark.drivers import train_image
from benchmark.reference import Products, exact_f32
from benchmark.reference import resnet as ref_resnet


def _feed(ctx: harness.Context) -> train_image.Feed:
    """The whole batch on every rank (the mesh step takes its rows)."""
    mix = dict(ctx.mix, batch=ctx.mix["batch"] * ctx.world.size)
    return train_image.Feed(mix, ctx.config, ctx.seed, ctx.device)


def build(cfg: dict, seed: int, device):
    """The program's train state on a dp mesh over every rank, and its
    mesh step."""
    from kubeflow_tpu_torch.models.convert import shard_state
    from kubeflow_tpu_torch.models.train import make_train_step
    from kubeflow_tpu_torch.parallel import MeshSpec, make_mesh

    state, _ = train_image.build(cfg, seed, device)
    mesh = make_mesh(MeshSpec(dp=dist.get_world_size()), device=device)
    state = shard_state(state, mesh)
    return state, make_train_step(mesh=mesh,
                                  smoothing=cfg["label_smoothing"])


def run(ctx: harness.Context, wrap_step=None,
        window: bool = True) -> harness.Outcome:
    """As the one-card driver's ``run``, on every rank."""
    cfg, mix, device, world = ctx.config, ctx.mix, ctx.device, ctx.world
    sync = sync_fn(device)
    feed = _feed(ctx)
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
            grad = train_image.first_gradient(cfg, state, start)
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
        elapsed = time.perf_counter() - t0
        trace_due, done = world.agree([
            ctx.trace and reading.trace is None
            and elapsed >= mix["trace_after_s"],
            steps > 0 and elapsed >= ctx.seconds])
        if done:
            break
        if trace_due:
            reading.trace = train_image._traced(step, state, feed, i,
                                                mix["trace_steps"], sync)
            i += mix["trace_steps"]
            steps += mix["trace_steps"]
            continue
        state, out = step(state, feed(i))
        if pending is not None:
            float(pending)
        pending = out["loss"]
        i, steps = i + 1, steps + 1
    if pending is not None:
        float(pending)
    seconds = time.perf_counter() - t0
    peak, = world.reduce([memory_peak(device)], op="max")
    images = steps * feed.images.shape[1]
    reading.counts.update(config=cfg, cards=world.size,
                          traced_steps=mix["trace_steps"],
                          traced_images=(mix["trace_steps"]
                                         * feed.images.shape[1]))
    if reading.trace is not None:
        reading.trace = reading.trace.trace
        busy, span = world.reduce([reading.trace.busy_s,
                                   reading.trace.window_s])
        reading.device_busy = (busy / world.size, span / world.size)
    del state, step
    free(device)
    ref_losses, ref_grad, ref_change = reference(ctx, feed, Products())
    checks, notes = compare.training_checks(
        ctx.limits, losses, ref_losses, grad, ref_grad, change, ref_change)
    return harness.Outcome(
        end_to_end={"images_per_s": images / seconds, "setup_s": setup_s},
        attempted=steps, failed=0, checks=checks,
        memory_peak_bytes=int(peak),
        reading=reading if ctx.trace else None, notes=notes)


def reference(ctx: harness.Context, feed: train_image.Feed,
              prod: Products):
    """(losses, first gradient norms, change norms) of the plain
    reference over the compared steps, this rank's rows of each batch,
    the sums over the NCCL world."""
    cfg, device, world = ctx.config, ctx.device, ctx.world
    rows = feed.images.shape[1] // world.size
    mine = slice(world.rank * rows, (world.rank + 1) * rows)
    batches = [(feed(i)["image"][mine], feed(i)["label"][mine])
               for i in range(ctx.mix["compared_steps"])]
    with exact_f32():
        p, stats = weights.resnet(cfg, ctx.seed, device)
        start = {k: v.clone() for k, v in p.items()}
        losses, first = ref_resnet.train(p, stats, cfg, batches,
                                         cfg["optimizer"], prod,
                                         group=dist.group.WORLD)
        change = compare.norms({k: p[k] - start[k] for k in p})
    return losses, compare.norms(first), change


def control(ctx: harness.Context) -> tuple[list, dict]:
    """The fp8 reference in the program's place, read as the program
    is: (checks, notes) against the f32 reference."""
    feed = _feed(ctx)
    low = reference(ctx, feed, Products(fp8=True))
    ref = reference(ctx, feed, Products())
    return compare.training_checks(ctx.limits, low[0], ref[0], low[1],
                                   ref[1], low[2], ref[2])


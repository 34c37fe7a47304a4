"""The span readers (``benchmark/spans.py`` and the six
``metrics/{forward,backward,optimizer}_ms.{train,image}.py``) on
synthetic traces with a known pairing, and on a CPU trace of the
program's own steps."""

import pytest
import torch

from benchmark import harness, plants, spans, tracing
from benchmark.drivers import train_lm

READERS = {f"{part}_ms.{cell}": f"train.{part}"
           for part in ("forward", "backward", "optimizer")
           for cell in ("train", "image")}


def _step(t0: float) -> tuple[list, list]:
    """One 0.5 s step from ``t0``: its host events and device operations.
    The second forward kernel runs on into the backward's host time, and
    belongs to the forward, where it was enqueued."""
    host = [("train.step", t0, t0 + 0.5),
            ("train.forward", t0, t0 + 0.2),
            ("cudaLaunchKernel", t0 + 0.01, t0 + 0.011),
            ("cudaLaunchKernel", t0 + 0.05, t0 + 0.051),
            ("train.backward", t0 + 0.2, t0 + 0.4),
            ("cudaEventRecord", t0 + 0.22, t0 + 0.221),
            ("cuLaunchKernel", t0 + 0.25, t0 + 0.251),
            ("train.optimizer", t0 + 0.4, t0 + 0.5),
            ("cudaMemcpyAsync", t0 + 0.41, t0 + 0.411)]
    kernels = [("k1", t0 + 0.02, t0 + 0.15), ("k2", t0 + 0.15, t0 + 0.30),
               ("k3", t0 + 0.30, t0 + 0.42),
               ("Memcpy DtoD", t0 + 0.45, t0 + 0.5)]
    return host, kernels


def _trace(steps: int = 2) -> tracing.Trace:
    host, kernels = [], []
    for i in range(steps):
        h, k = _step(0.5 * i)
        host += h
        kernels += k
    return tracing.Trace(window_s=0.5 * steps, kernels=kernels, host=host)


# Per step: forward k1 + k2 + the leading gap (0.13 + 0.15 + 0.02),
# backward k3, optimizer the gap before the copy and the copy.
EXPECTED_MS = {"train.forward": 300.0, "train.backward": 120.0,
               "train.optimizer": 80.0}


def test_a_known_pairing_gives_exact_milliseconds_that_fill_the_window():
    trace = _trace()
    split = spans.split_ms(trace)
    assert split == pytest.approx(EXPECTED_MS, abs=1e-9)
    assert sum(split.values()) == pytest.approx(1000 * trace.window_s / 2)


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_its_span(name):
    reader = harness.metric_reader(name)
    value = reader.read(harness.Reading(trace=_trace(3)))
    assert value == pytest.approx(EXPECTED_MS[READERS[name]], abs=1e-9)


def test_enqueue_calls_that_do_not_pair_give_none():
    trace = _trace()
    trace.host = [h for h in trace.host if h[0] != "cuLaunchKernel"
                  or h[1] > 0.5]
    assert spans.split_ms(trace) is None
    assert harness.metric_reader("forward_ms.train").read(
        harness.Reading(trace=trace)) is None


def test_a_trace_without_a_step_gives_none():
    trace = _trace()
    trace.host = [h for h in trace.host if h[0] != spans.STEP]
    assert spans.split_ms(trace) is None
    for name in READERS:
        assert harness.metric_reader(name).read(
            harness.Reading(trace=trace)) is None


def test_the_programs_own_steps_split_a_cpu_window():
    """The program's spans come through ``tracing.Window``: on the CPU
    there is no device operation, so the window is one idle gap, which
    goes to the span the host was in at its middle."""
    ctx = plants.tiny("lm-train-2k-packed")
    feed = train_lm.Feed(ctx.mix, ctx.config, ctx.seed, ctx.device)
    state, step = train_lm.build(ctx.config, ctx.seed, ctx.device)
    state, _ = step(state, feed(0))
    with tracing.Window(lambda: None) as window:
        for i in range(2):
            state, _ = step(state, feed(i))
    trace = window.trace
    assert sum(1 for n, _, _ in trace.host if n == spans.STEP) == 2
    split = spans.split_ms(trace)
    assert sum(split.values()) == pytest.approx(1000 * trace.window_s / 2)
    assert torch.isfinite(torch.tensor(list(split.values()))).all()

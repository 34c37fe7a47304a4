"""Run one cell: ``python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the correctness comparison read, beside its limit. The same
checks are the last lines of standard error.

Exits non-zero and prints no result when there is no card or fewer
than the cell asks for, when the program does not import from this
checkout, or when a module of JAX or the JAX package was loaded.

A cell on several cards runs one process a card (``benchmark.world``):
this one is rank 0 and the only one that prints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from benchmark import harness, world


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so a
    second run of a cell finds what the first one built. The port's own
    kernels build into ``kubeflow_tpu_torch/build/`` (fixed in its
    code, inside the checkout)."""
    cache = harness.ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seconds <= 0:
        parser.error("--seconds must be positive")
    return args


def main(argv=None) -> int:
    setup_start = harness.process_start()
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    doc = harness.manifest()
    cell = harness.find_cell(doc, args.workload)
    _cache_dirs()
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        harness.log(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                    f"found {torch.cuda.device_count()}")
        return 2
    why = harness.program_root_ok()
    if why is not None:
        harness.log(why)
        return 2
    mix = harness.traffic(cell["traffic"])
    group = None
    if cell["chips"] > 1:
        group = world.start(cell["chips"], "benchmark.run", argv,
                            cwd=harness.ROOT)
    ctx = harness.Context(
        config=harness.config(cell["config"]), mix=mix,
        limits=harness.limits(cell["name"]), seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace),
        setup_start=setup_start, device=torch.device("cuda", world.rank()),
        world=group)
    try:
        outcome = harness.driver(mix["driver"]).run(ctx)
    except BaseException:
        if group is not None:
            group.finish(ok=False)
        raise
    if group is not None:
        finished = group.finish()
        if group.rank != 0:
            return 0
        if not finished:
            harness.log("a rank other than 0 failed")
            return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes}
    breakdown = None
    if args.trace:
        trace = outcome.reading.trace
        device["busy_s"], device["window_s"] = (
            outcome.reading.device_busy or (trace.busy_s, trace.window_s))
        breakdown = trace.breakdown()
    line = harness.result(outcome, doc, cell["name"], bool(args.trace),
                          device, breakdown)
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        harness.log(f"loaded modules of JAX or the JAX package: {bad}")
        return 3
    for note, value in outcome.notes.items():
        harness.log(f"note {note} {value!r}")
    for text in harness.check_lines(outcome.checks):
        harness.log(text)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

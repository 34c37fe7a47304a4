"""The readings a cell's limits are set from, on the card:
``python3 -m benchmark.tools.readings --workload <cell> --seeds a,b,..
[--control] [--fault name]``.

For each seed, one JSON line with the program's compared numbers: the
cell's set-up steps against the reference, with no window. With
``--control`` also the control's: the reference computed on fp8
operands in the program's place. With ``--fault`` the program's step
carries that fault (``benchmark.plants.STEP_FAULTS``). All seeds run in
this one process (one a card, on several cards: ``benchmark.world``),
so set-up is paid once a seed, not once a process.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from benchmark import harness, plants, world


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", choices=sorted(plants.STEP_FAULTS))
    argv = sys.argv[1:] if argv is None else argv
    args = parser.parse_args(argv)
    doc = harness.manifest()
    cell = harness.find_cell(doc, args.workload)
    mix = harness.traffic(cell["traffic"])
    driver = harness.driver(mix["driver"])
    group = None
    if cell["chips"] > 1:
        group = world.start(cell["chips"], "benchmark.tools.readings", argv,
                            cwd=harness.ROOT)
    base = harness.Context(
        config=harness.config(cell["config"]), mix=mix,
        limits=harness.limits(cell["name"]), seed=0, seconds=0.0,
        trace=False, setup_start=time.perf_counter(),
        device=torch.device("cuda", world.rank()), world=group)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = dataclasses.replace(base, seed=seed)
        line = {"seed": seed, "fault": args.fault}
        out = driver.run(ctx, window=False, wrap_step=(
            plants.STEP_FAULTS[args.fault] if args.fault else None))
        line["program"] = {name: value for name, value, _ in out.checks}
        line["notes"] = out.notes
        if args.control:
            low, low_notes = driver.control(ctx)
            line["control"] = {name: value for name, value, _ in low}
            line["control_notes"] = low_notes
        if world.rank() == 0:
            print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0 if group is None or group.finish() else 4


if __name__ == "__main__":
    raise SystemExit(main())

"""Four CPU ranks over gloo run the tiny data-parallel image cell, once
sound and once with each step fault planted, and rank 0 prints one JSON
line a run: ``{"fault", "correct", "checks"}``. Started by
``test_faults.py``: ``python3 -m benchmark.tests.dp_world``."""

from __future__ import annotations

import dataclasses
import json
import sys

from benchmark import harness, plants, world
from benchmark.drivers import train_image_dp

# The four-card cell, as BENCHMARK.json would list it (it does not yet:
# PERF.md, section 7).
CELL = {"name": "resnet50-train-dp4", "config": "resnet50",
        "traffic": "images-256-dp", "chips": 4}
RANKS = 4


def main() -> int:
    group = world.start(RANKS, "benchmark.tests.dp_world", [],
                        device_type="cpu", cwd=harness.ROOT)
    ctx = dataclasses.replace(plants.tiny(CELL), world=group)
    for fault in [None, *plants.STEP_FAULTS]:
        out = train_image_dp.run(ctx, wrap_step=(
            plants.STEP_FAULTS[fault] if fault else None))
        if group.rank == 0:
            print(json.dumps({"fault": fault,
                              "correct": harness.correct(out.checks),
                              "checks": out.checks}), flush=True)
    return 0 if group.finish() else 4


if __name__ == "__main__":
    sys.exit(main())

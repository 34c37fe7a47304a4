"""The control at each cell's own size, on the card: the reference
computed on fp8 operands in the program's place reads past the cell's
limits. ``python3 -m pytest benchmark/tests -m cuda`` on the card; it
skips elsewhere."""

import time

import pytest
import torch

from benchmark import harness

CELLS = ["lm-train-2k-packed", "resnet50-train"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0)):
        pytest.skip("needs an NVIDIA sm_90 card")
    doc = harness.manifest()
    c = harness.find_cell(doc, cell)
    mix = harness.traffic(c["traffic"])
    ctx = harness.Context(
        config=harness.config(c["config"]), mix=mix,
        limits=harness.limits(cell), seed=2 ** 31 + 101, seconds=10.0,
        trace=False, setup_start=time.perf_counter(),
        device=torch.device("cuda", 0))
    checks, _ = harness.driver(mix["driver"]).control(ctx)
    assert not harness.correct(checks), checks


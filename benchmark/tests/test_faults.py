"""A run with its timed path broken underneath comes out not correct;
the same tiny run unbroken comes out correct. CPU, tiny sizes, the
cells' own limits."""

import pytest

from benchmark import harness
from benchmark.drivers import train_image, train_lm
from benchmark import plants

TRAIN = [("lm-train-2k-packed", train_lm), ("resnet50-train", train_image)]


@pytest.mark.parametrize("cell,driver", TRAIN, ids=[c for c, _ in TRAIN])
def test_a_sound_training_run_is_correct(cell, driver):
    out = driver.run(plants.tiny(cell))
    assert harness.correct(out.checks), out.checks


@pytest.mark.parametrize("plant", [plants.unchanged_state,
                                   plants.half_batch],
                         ids=["unchanged_state", "half_batch"])
@pytest.mark.parametrize("cell,driver", TRAIN, ids=[c for c, _ in TRAIN])
def test_a_broken_training_step_is_not_correct(cell, driver, plant):
    out = driver.run(plants.tiny(cell), wrap_step=plant)
    assert not harness.correct(out.checks), out.checks



def test_the_dp_cell_is_correct_and_each_fault_is_not():
    import json
    import os
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "benchmark.tests.dp_world"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "2"},
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    runs = {r["fault"]: r for r in map(json.loads, out.stdout.splitlines())}
    assert set(runs) == {None, *plants.STEP_FAULTS}
    assert runs.pop(None)["correct"], out.stdout
    assert not any(r["correct"] for r in runs.values()), out.stdout

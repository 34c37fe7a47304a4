"""The planted faults of ``testing/torch_fault_check.sh`` still land.

The script plants each fault in a copy of ``csrc/flash_bwd.cu`` with one
``sed`` expression and runs the card checks on the copy. A rewrite of the
kernels that no longer contains an expression's target would disarm the
plant silently (the script would test the sound kernels under the
fault's name), so each expression is applied here to a copy of the
current source and must change the lines it is meant to change.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "testing" / "torch_fault_check.sh"
SOURCE = REPO / "kubeflow_tpu_torch" / "csrc" / "flash_bwd.cu"

# fault -> (lines the plant changes, text every changed line then holds)
PLANTS = {
    "dq_diagonal": (1, "pair_live(hi ? r_hi : r_lo, col + 1,"),
    "dkv_last_tile": (1, "q0 >= q_end - kTile"),
    "dkv_group_head": (3, "g < group - 1"),
}


def _expressions() -> dict[str, str]:
    found = re.findall(r"^\s*(\w+)\) expr='(.*)' ;;$", SCRIPT.read_text(),
                       flags=re.MULTILINE)
    return dict(found)


def test_the_script_plants_exactly_these_faults():
    exprs = _expressions()
    assert exprs.pop("none") == ""
    assert sorted(exprs) == sorted(PLANTS)


@pytest.mark.parametrize("fault", sorted(PLANTS))
def test_plant_changes_the_kernel_source(fault, tmp_path):
    copy = tmp_path / SOURCE.name
    shutil.copy(SOURCE, copy)
    subprocess.run(["sed", "-i", _expressions()[fault], str(copy)],
                   check=True)
    before = SOURCE.read_text().splitlines()
    after = copy.read_text().splitlines()
    assert len(before) == len(after)
    changed = [new for old, new in zip(before, after) if old != new]
    lines, text = PLANTS[fault]
    assert len(changed) == lines, changed
    assert all(text in line for line in changed), changed

"""The planted faults of ``testing/torch_fault_check.sh`` still land.

The script plants each fault in a copy of the kernel source it names
(under ``kubeflow_tpu_torch/csrc/``) with one ``sed`` expression and runs
the card checks on the copy. A rewrite of the
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
CSRC = REPO / "kubeflow_tpu_torch" / "csrc"

# fault -> (source, lines the plant changes, text every changed line then
# holds)
PLANTS = {
    "dq_diagonal": ("flash_bwd.cu", 1, "pair_live(hi ? r_hi : r_lo, col + 1,"),
    "dkv_last_tile": ("flash_bwd.cu", 1, "q0 >= q_end - kTile"),
    "dkv_group_head": ("flash_bwd.cu", 3, "g < group - 1"),
    "fwd_diagonal": ("flash_fwd.cu", 1, "pair_live(row, col + 1,"),
    "fwd_last_tile": ("flash_fwd.cu", 1, "while (k0 + kTile < k_end) {"),
    "gemv_last_split": ("gemv.cu", 1, "src < nsplit - 1 ?"),
    "decode_last_slice": ("decode_attention.cu", 1, "src < kSplit - 1 ?"),
    "qkv_rope_partner": ("decode_qkv.cu", 1, "t1 + kTilePairs - 1;"),
}


def _plants() -> dict[str, tuple[str, str]]:
    """fault -> (source file, sed expression), as the script has them."""
    found = re.findall(r"^\s*(\w+)\) file=(\S*) expr='(.*)' ;;$",
                       SCRIPT.read_text(), flags=re.MULTILINE)
    return {fault: (file, expr) for fault, file, expr in found}


def test_the_script_plants_exactly_these_faults():
    plants = _plants()
    assert plants.pop("none") == ("", "")
    assert sorted(plants) == sorted(PLANTS)
    for fault, (file, _) in plants.items():
        assert file == PLANTS[fault][0], fault


@pytest.mark.parametrize("fault", sorted(PLANTS))
def test_plant_changes_the_kernel_source(fault, tmp_path):
    name, expr = _plants()[fault]
    source = CSRC / name
    copy = tmp_path / name
    shutil.copy(source, copy)
    subprocess.run(["sed", "-i", expr, str(copy)], check=True)
    before = source.read_text().splitlines()
    after = copy.read_text().splitlines()
    assert len(before) == len(after)
    changed = [new for old, new in zip(before, after) if old != new]
    _, lines, text = PLANTS[fault]
    assert len(changed) == lines, changed
    assert all(text in line for line in changed), changed

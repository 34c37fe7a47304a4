#!/usr/bin/env bash
# Plant one fault in a copy of the port's flash backward kernels and read
# what each check makes of it: chip_smoke.py (it stops in its kernel
# phase), the card tests, and the train configuration's step-0 gradient
# readings (chip_smoke.step0_readings), which the smoke never reaches
# under a fault. The repo itself is never edited: the copy lives under
# build/torch_faults/<fault>/.
#
# Run from the root of a checkout, on a machine with one H100 and nvcc:
#   testing/torch_fault_check.sh none|dq_diagonal|dkv_last_tile|dkv_group_head
# none          the sound kernels (the readings' control)
# dq_diagonal   dq drops the diagonal (its causal mask shifted by one key)
# dkv_last_tile dk/dv skip the last query tile of every key block
# dkv_group_head dk/dv skip the last query head of every GQA group (all
#               heads when kv heads = heads)
set -uo pipefail

fault=${1:?usage: $0 none|dq_diagonal|dkv_last_tile|dkv_group_head}
case $fault in
  none) expr='' ;;
  dq_diagonal) expr='s/pair_live(hi ? r_hi : r_lo, col,/pair_live(hi ? r_hi : r_lo, col + 1,/' ;;
  dkv_last_tile) expr='s/if (q0 >= q_end) {/if (q0 >= q_end - kTile) {/' ;;
  dkv_group_head) expr='s/g < group/g < group - 1/' ;;
  *) echo "unknown fault: $fault" >&2; exit 2 ;;
esac

root=$(pwd)
work=$root/build/torch_faults/$fault
rm -rf "$work"
mkdir -p "$work/tests"
cp -r kubeflow_tpu_torch chip_smoke.py "$work/"
cp tests/test_torch_cuda.py "$work/tests/"
rm -rf "$work/kubeflow_tpu_torch/build"
src=$work/kubeflow_tpu_torch/csrc/flash_bwd.cu
if [ -n "$expr" ]; then
  sed -i "$expr" "$src"
  if cmp -s "$src" kubeflow_tpu_torch/csrc/flash_bwd.cu; then
    echo "fault $fault was not planted" >&2
    exit 2
  fi
fi

cd "$work" || exit 2
python3 chip_smoke.py > smoke.out 2>&1
echo "fault=$fault smoke_rc=$? $(grep -m1 -o 'AssertionError: .*' smoke.out)"
python3 -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py \
  2>&1 | tail -n 1 | sed "s/^/fault=$fault card_tests: /"
FAULT=$fault python3 - <<'EOF'
import json
import os

import torch

import chip_smoke

cfg, state, tokens = chip_smoke.train_setup(torch)
readings = chip_smoke.step0_readings(torch, cfg, state, tokens)
print(json.dumps({"fault": os.environ["FAULT"], "loss": readings["loss"],
                  "worst": readings["worst"]}))
EOF

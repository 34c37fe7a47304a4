#!/usr/bin/env bash
# Plant one fault in a copy of one of the port's kernels and read what
# each check makes of it: chip_smoke.py (it stops in its kernel phase),
# the card tests, and the train configuration's step-0 gradient readings
# (chip_smoke.step0_readings), which the smoke never reaches under a
# fault. The repo itself is never edited: the copy lives under
# build/torch_faults/<fault>/.
#
# Run from the root of a checkout, on a machine with one H100 and nvcc:
#   testing/torch_fault_check.sh <fault>
# Each fault names the source under kubeflow_tpu_torch/csrc/ it rewrites:
# none            the sound kernels (the readings' control)
# dq_diagonal     flash_bwd.cu: dq drops the diagonal (its causal mask
#                 shifted by one key)
# dkv_last_tile   flash_bwd.cu: dk/dv skip the last query tile of every
#                 key block
# dkv_group_head  flash_bwd.cu: dk/dv skip the last query head of every
#                 GQA group (all heads when kv heads = heads)
# fwd_diagonal    flash_fwd.cu: the forward's causal mask shifted by one key
# fwd_last_tile   flash_fwd.cu: the forward skips its last live key tile
# gemv_last_split gemv.cu: the (K, N) GEMV drops its last K slice's partial
# decode_last_slice decode_attention.cu: the cluster's combine drops the
#                 last slice of every row's live range
# qkv_rope_partner decode_qkv.cu: each pair takes its partner's sum from
#                 the wrong tile column (RoPE rotates with the wrong partner)
set -uo pipefail

fault=${1:?usage: $0 <fault> (see the header)}
case $fault in
  none) file= expr='' ;;
  dq_diagonal) file=flash_bwd.cu expr='s/pair_live(hi ? r_hi : r_lo, col,/pair_live(hi ? r_hi : r_lo, col + 1,/' ;;
  dkv_last_tile) file=flash_bwd.cu expr='s/if (q0 >= q_end) {/if (q0 >= q_end - kTile) {/' ;;
  dkv_group_head) file=flash_bwd.cu expr='s/g < group/g < group - 1/' ;;
  fwd_diagonal) file=flash_fwd.cu expr='s/pair_live(row, col,/pair_live(row, col + 1,/' ;;
  fwd_last_tile) file=flash_fwd.cu expr='s/while (k0 < k_end) {/while (k0 + kTile < k_end) {/' ;;
  gemv_last_split) file=gemv.cu expr='s/src < nsplit ?/src < nsplit - 1 ?/' ;;
  decode_last_slice) file=decode_attention.cu expr='s/const float f = ls\[src\] > 0.f ?/const float f = ls[src] > 0.f \&\& src < kSplit - 1 ?/' ;;
  qkv_rope_partner) file=decode_qkv.cu expr='s/const int t2 = t1 + kTilePairs;/const int t2 = t1 + kTilePairs - 1;/' ;;
  *) echo "unknown fault: $fault" >&2; exit 2 ;;
esac

root=$(pwd)
work=$root/build/torch_faults/$fault
rm -rf "$work"
mkdir -p "$work/tests"
cp -r kubeflow_tpu_torch chip_smoke.py "$work/"
cp tests/test_torch_cuda.py "$work/tests/"
rm -rf "$work/kubeflow_tpu_torch/build"
if [ -n "$expr" ]; then
  src=$work/kubeflow_tpu_torch/csrc/$file
  sed -i "$expr" "$src"
  if cmp -s "$src" "kubeflow_tpu_torch/csrc/$file"; then
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

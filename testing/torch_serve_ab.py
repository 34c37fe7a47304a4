#!/usr/bin/env python3
"""Time the serve run of two checkouts in turns on one card: A B B A.

Each turn runs, in a fresh process from the root of that checkout,
``chip_smoke.py``'s serve phase twice (the flagship's 8 streamed
requests, checked against ``generate``; the first run warms up and is
not kept) and its trace phase (the same requests under
``torch.profiler``), after building that checkout's kernels, and prints
one JSON line: the checkout, ``decode_step_ms``, prefill tokens/s, the
trace's device busy ms and idle share, the device ms of each group the
trace lists first, and the host microseconds to enqueue one call of
decode attention and of the fused QKV+RoPE at the flagship's shapes. Host times vary from machine to machine and run
to run; comparing two checkouts is fair only within one call, in turns.

Run from the root of a checkout on a machine with one H100 and nvcc:
``python3 testing/torch_serve_ab.py <other checkout> [rounds]`` (the
other checkout is, e.g., the parent commit unpacked with ``git archive``
into a directory that .gitignore lists).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

TURN = """
import json, time, torch, chip_smoke
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.decode_attention import decode_attention
from kubeflow_tpu_torch.ops.decode_qkv import qkv_rope
_build.library()
cfg = chip_smoke.flagship(torch)
chip_smoke.serve_phase(torch, cfg)   # warm-up: first calls, allocator
serve, params = chip_smoke.serve_phase(torch, cfg)
trace = chip_smoke.trace_phase(torch, cfg, params)

def host_us(fn, calls=200):
    # host microseconds to enqueue one call (the serve run is host-bound)
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    spent = time.perf_counter() - start
    torch.cuda.synchronize()
    return spent / calls * 1e6

bf16 = torch.bfloat16
q = torch.randn(8, 8, 1, 128, device="cuda").to(bf16)
kc = torch.randn(8, 2, 2048, 128, device="cuda").to(bf16)
pos = torch.full((8,), 1000, dtype=torch.int32, device="cuda")
x = torch.randn(8, 1024, device="cuda").to(bf16)
w = torch.randn(1024, 1536, device="cuda").to(bf16)
print(json.dumps({
    "decode_step_ms": serve["decode_step_ms"],
    "prefill_tok_s": serve["prefill_tok_s"],
    "device_busy_ms": trace["device_busy_ms"],
    "device_window_ms": trace["device_window_ms"],
    "idle_share": trace["idle_share"],
    "host_us_per_call": {
        "decode_attention": host_us(lambda: decode_attention(q, kc, kc, pos)),
        "qkv_rope": host_us(lambda: qkv_rope(x, w, pos, head_dim=128,
                                             rope_heads=10))},
    "groups": {g["name"]: g["ms"] for g in trace["groups"][:10]}}))
"""


def turn(tree: Path) -> dict:
    done = subprocess.run([sys.executable, "-c", TURN], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    if done.returncode:
        raise SystemExit(f"{tree}: serve turn failed\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    for _ in range(rounds):
        for name, tree in (("this", REPO), ("other", other), ("other", other),
                           ("this", REPO)):
            print(json.dumps({"tree": name, "path": str(tree),
                              **turn(tree)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

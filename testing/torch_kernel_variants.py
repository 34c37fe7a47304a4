#!/usr/bin/env python3
"""Time variants of the port's flash forward and GEMV, each with one part
taken out, beside the unmodified kernel, in one process on one card.

A variant is the kernel source with one ``sed`` expression applied (the
copies live under ``build/kernel_variants/``; the repo is never edited).
Each source is built alone into its own library with the build's flags
and called through the same C entry, so the differences between the
times say what each part costs at the main path's shapes: the forward at
the training shape with lse and at the flagship's prefill, the GEMV at
the decode step's projections and the tied head. The outputs of a
variant are wrong by design and are not checked.

Run from the root of a checkout on a machine with one H100 and nvcc:
``python3 testing/torch_kernel_variants.py``. Prints one JSON line per
shape (device ms, CUDA events, L2 flushed before each launch, as in
``chip_smoke.py``) and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from kubeflow_tpu_torch.ops import _build  # noqa: E402

WORK = REPO / "build" / "kernel_variants"
# source -> {variant: sed expression or None for the unmodified source}
VARIANTS = {
    "flash_fwd.cu": {
        "base": None,
        "no_mask": r"s/      if (!tile_full(q0, k0, Sq, Sk, causal, window, segb)) {"
                   r"/      if (false) {/",
        "no_exp": r"s/float p = exp2_approx(s\[i\] - (hi ? m_hi : m_lo));"
                  r"/float p = s[i];/",
        "no_kv_copies": r"s/if (k_next < k_end) load_kv(k_next, t + 1);"
                        r"/if (false) load_kv(k_next, t + 1);/",
        "no_pv": r"/issue_pv<D>(acc, frag, sv_prev, pass);/d",
        "no_scores": r"/issue_scores<D>(s, sq, ring_k/d",
    },
    "gemv.cu": {
        "base": None,
        "empty": r"s/^  cg::cluster_group cluster = cg::this_cluster();"
                 r"/  if (rows > 0) return;\n&/",
        "one_slice": r"s/while (nsplit < kMaxSplit &&/while (false \&\&/",
        "no_cluster_sum": r"s/    if (tid + u \* NT >= share) break;/    break;/",
        "threads_128": r"s/if (2 \* tiles >= kMinBlocks)/if (false)/",
        "threads_256": r"s/  return launch_kn<WT, kThreads>(xp/"
                       r"  return launch_kn<WT, 2 * kThreads>(xp/",
    },
}


def build_variants() -> dict[tuple[str, str], ctypes.CDLL]:
    """One library per (source, variant), all compiled in parallel."""
    shutil.rmtree(WORK, ignore_errors=True)
    nvcc = _build._nvcc()
    procs = {}
    for source, table in VARIANTS.items():
        for name, expr in table.items():
            copy = WORK / f"{Path(source).stem}_{name}"
            shutil.copytree(_build.SRC_DIR, copy)
            if expr is not None:
                subprocess.run(["sed", "-i", expr, str(copy / source)],
                               check=True)
                if ((copy / source).read_text()
                        == (_build.SRC_DIR / source).read_text()):
                    raise SystemExit(f"variant {source}:{name} changed "
                                     "nothing: its expression is stale")
            cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(copy), "-shared",
                   "-o", str(copy / "lib.so"), str(copy / source)]
            procs[(source, name)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    libs = {}
    for (source, name), proc in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {source}:{name} failed to build:\n"
                             f"{output}")
        lib = ctypes.CDLL(str(WORK / f"{Path(source).stem}_{name}" / "lib.so"))
        entry = "kft_flash_fwd" if source == "flash_fwd.cu" else "kft_gemv"
        getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
        libs[(source, name)] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    libs = build_variants()
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).bfloat16()

    ptr = _build.ptr
    stream = torch.cuda.current_stream().cuda_stream
    for case, b, h, hkv, s in [("train_lse", 4, 8, 8, 2048),
                               ("prefill", 1, 8, 2, 1024)]:
        q, k, v = randn(b, h, s, 128), randn(b, hkv, s, 128), randn(
            b, hkv, s, 128)
        out = torch.empty_like(q)
        lse = (torch.empty(b, h, s, device="cuda")
               if case == "train_lse" else None)
        row = {"kernel": "flash_fwd", "case": case}
        for (source, name), lib in libs.items():
            if source != "flash_fwd.cu":
                continue

            def call(lib=lib):
                return lib.kft_flash_fwd(
                    ptr(q), ptr(k), ptr(v), None, ptr(out), ptr(lse), b, h,
                    hkv, s, s, 128, 1, 0, 128 ** -0.5, stream)

            _build.check(call(), name)
            row[name] = timer(call, 10)
        row["sdpa"] = timer(lambda: torch.nn.functional.
                            scaled_dot_product_attention(
                                q, k, v, is_causal=True, enable_gqa=True), 10)
        print(json.dumps(row), flush=True)
    for case, kdim, n, residual, transpose, int8 in [
            ("proj_residual", 1024, 1024, True, 0, 0),
            ("up", 1024, 4096, False, 0, 0),
            ("down_residual", 4096, 1024, True, 0, 0),
            ("tied_head", 1024, 32768, False, 1, 0),
            ("int8_residual", 1024, 4096, True, 0, 1)]:
        x = randn(8, kdim)
        w = randn(*((n, kdim) if transpose else (kdim, n)), std=kdim ** -0.5)
        scale = None
        if int8:
            scale = (w.float().abs().amax(0) / 127.0).contiguous()
            w = torch.round(w.float() / scale).to(torch.int8)
        res = randn(8, n) if residual else None
        out = torch.empty(8, n, device="cuda",
                          dtype=torch.bfloat16 if residual else torch.float32)
        row = {"kernel": "gemv", "case": case}
        for (source, name), lib in libs.items():
            if source != "gemv.cu":
                continue

            def call(lib=lib):
                return lib.kft_gemv(ptr(x), ptr(w), ptr(scale), ptr(res),
                                    ptr(out), 8, kdim, n, int8, transpose,
                                    stream)

            _build.check(call(), name)
            row[name] = timer(call)
        wmat = w.t() if transpose else w
        row["matmul"] = (None if int8 else
                         timer(lambda: torch.matmul(x, wmat)))
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time variants of the port's flash forward, GEMV, fused QKV+RoPE and
decode attention, each with one part taken out or one choice changed,
beside the unmodified kernel, in one process on one card.

A variant is the kernel source with one ``sed`` expression applied (the
copies live under ``build/kernel_variants/``; the repo is never edited).
Each source is built alone into its own library with the build's flags
and called through the same C entry, so the differences between the
times say what each part costs at the main path's shapes: the forward at
the training shape with lse and at the flagship's prefill, the GEMV at
the decode step's projections and the tied head, the fused QKV+RoPE and
decode attention at the kernel phase's flagship and serve shapes. The
outputs of a variant are wrong by design and are not checked.

Run from the root of a checkout on a machine with one H100 and nvcc:
``python3 testing/torch_kernel_variants.py [source.cu ...]`` (default:
every source below). Prints one JSON line per shape (device ms, CUDA
events, L2 flushed before each launch, as in ``chip_smoke.py``) and the
card's name and power limit.
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
        "one_slice": r"s/const int nsplit = kn_splits(tiles, k, kRowsPerStep);"
                     r"/const int nsplit = 1;/",
        "no_cluster_sum": r"s/    if (tid + u \* NT >= share) break;/    break;/",
        "threads_128": r"s/if (2 \* tiles >= kMinBlocks)/if (false)/",
        "threads_256": r"s/  return launch_kn<WT, kThreads>(xp/"
                       r"  return launch_kn<WT, 2 * kThreads>(xp/",
    },
    "decode_qkv.cu": {
        "base": None,
        "eight_slices": r"s/constexpr int kMaxSlices = 4;"
                        r"/constexpr int kMaxSlices = 8;/",
        "two_slices": r"s/constexpr int kMaxSlices = 4;"
                      r"/constexpr int kMaxSlices = 2;/",
        "no_rope": r"s/const bool rotate = c1 < rope_cols;"
                   r"/const bool rotate = false;/",
    },
    "decode_attention.cu": {
        "base": None,
        "two_stages": r"s/constexpr int kStages = 3; /constexpr int kStages = 2; /",
        "four_stages": r"s/constexpr int kStages = 3; /constexpr int kStages = 4; /",
        "tile_32": r"s/HD == 256 ? 32 : 64;/HD == 256 ? 32 : 32;/",
        "no_combine": r"s/  for (int e = split \* share + tid;/  for (int e = 1 << 30;/",
        "no_loads": r"s/for (int j = 0; j < kCopies \/ kThreads; ++j) {"
                    r"/for (int j = 0; j < 0; ++j) {/",
        "sixteen_slices": r"s/constexpr int kSplit = 8; /constexpr int kSplit = 16; /;"
                          r"s/  if (B \* Hkv == 0) return 0;/  cudaFuncSetAttribute("
                          r"decode_attention_kernel<HD, KT>, "
                          r"cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n&/",
    },
}
# The C entry each source's library is called through.
ENTRIES = {"flash_fwd.cu": "kft_flash_fwd", "gemv.cu": "kft_gemv",
           "decode_qkv.cu": "kft_qkv_rope",
           "decode_attention.cu": "kft_decode_attention"}


def build_variants(sources) -> dict[tuple[str, str], ctypes.CDLL]:
    """One library per (source, variant), all compiled in parallel."""
    shutil.rmtree(WORK, ignore_errors=True)
    nvcc = _build._nvcc()
    procs = {}
    for source in sources:
        table = VARIANTS[source]
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
        entry = ENTRIES[source]
        getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
        libs[(source, name)] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sources = sys.argv[1:] or list(VARIANTS)
    unknown = set(sources) - set(VARIANTS)
    if unknown:
        print(f"no variants for {sorted(unknown)}", file=sys.stderr)
        return 2
    libs = build_variants(sources)
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
    for case, int8 in [("flagship", 0), ("int8", 1)]:
        x = randn(8, 1024)
        w = randn(1024, 1536, std=1024 ** -0.5)
        scale = None
        if int8:
            scale = (w.float().abs().amax(0) / 127.0).contiguous()
            w = torch.round(w.float() / scale).to(torch.int8)
        pos = torch.tensor([0, 1, 17, 255, 256, 1000, 1279, 513],
                           dtype=torch.int32, device="cuda")
        out = torch.empty(8, 1536, device="cuda", dtype=torch.bfloat16)
        row = {"kernel": "qkv_rope", "case": case}
        for (source, name), lib in libs.items():
            if source != "decode_qkv.cu":
                continue

            def call(lib=lib):
                return lib.kft_qkv_rope(ptr(x), ptr(w), ptr(scale), ptr(pos),
                                        ptr(out), 8, 1024, 1536, 128,
                                        10 * 128, 10000.0, int8, stream)

            _build.check(call(), name)
            row[name] = timer(call)
        print(json.dumps(row), flush=True)
    n = chip_smoke.SERVE_LENGTHS
    serve_pos = [p + 62 for p in (n[0], n[1], n[2], n[3], n[4], n[0], n[5],
                                  n[5] + n[6])]
    for case, cap, int8, pos_list in [
            ("serve_shape", 2048, 0, serve_pos),
            ("int8", 1280, 1, [0, 100, 255, 256, 700, 1279, 1000, 513])]:
        q = randn(8, 8, 1, 128)
        kc, vc = randn(8, 2, cap, 128), randn(8, 2, cap, 128)
        ks = vs = None
        if int8:
            ks = (kc.float().abs().amax(-1, keepdim=True) / 127.0)
            vs = (vc.float().abs().amax(-1, keepdim=True) / 127.0)
            kc = torch.round(kc.float() / ks).to(torch.int8)
            vc = torch.round(vc.float() / vs).to(torch.int8)
        pos = torch.tensor(pos_list, dtype=torch.int32, device="cuda")
        out = torch.empty_like(q)
        row = {"kernel": "decode_attention", "case": case}
        for (source, name), lib in libs.items():
            if source != "decode_attention.cu":
                continue

            def call(lib=lib):
                return lib.kft_decode_attention(
                    ptr(q), ptr(kc), ptr(vc), ptr(ks), ptr(vs), ptr(pos),
                    ptr(out), 8, 8, 2, cap, 128, 0, 0, 128 ** -0.5, int8,
                    stream)

            _build.check(call(), name)
            row[name] = timer(call)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build and bind the hand-written CUDA kernels in ``csrc/``.

At first use every ``csrc/*.cu`` is compiled for ``sm_90a`` with
``nvcc`` (one process per source, all started together), linked into
one shared library under ``kubeflow_tpu_torch/build/`` and loaded with
``ctypes``. The library's name carries a hash of the sources, so an
edited kernel is rebuilt and a current build is reused. Each C entry
takes raw device pointers, sizes and the caller's stream as plain
arguments and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero status.

Nothing here runs at import: the CPU tests import every module, and
this machine may have neither ``nvcc`` nor a card.

Environment: ``KFT_NVCC`` names the compiler (default ``nvcc`` on the
PATH, then ``/usr/local/cuda/bin/nvcc``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

# Launches per kernel wrapper: each wrapper adds one where it launches
# its kernel on the card, and nowhere else (the CPU twin is not a
# launch). chip_smoke.py zeroes these around the serving run and around
# the training run to show each path went through its kernels.
LAUNCHES = {"flash_attention": 0, "gemv": 0, "qkv_rope": 0,
            "decode_attention": 0, "flash_dq": 0, "flash_dkv": 0,
            "split3": 0, "bn_stats": 0, "bn_apply": 0, "bn_grad_sums": 0,
            "bn_dx": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "kft_gemv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "kft_qkv_rope": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "kft_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _F, _I, _P],
    "kft_flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _I, _F, _P],
    "kft_flash_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _I, _F, _P],
    "kft_flash_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _I, _I, _I, _I, _F, _P],
    "kft_split3": [_P, _P, _L, _L, _P],
    "kft_bn_row_blocks": [_L, _I, _I],
    "kft_bn_stats": [_P, _P, _P, _L, _I, _I, _F, _P],
    "kft_bn_apply": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I,
                     _I, _F, _F, _F, _P],
    "kft_bn_grad_sums": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _P],
    "kft_bn_dx": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _F, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    explicit = os.environ.get("KFT_NVCC")
    if explicit:
        return explicit
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled at "
                       "first use on a machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    digest = hashlib.sha256()
    for path in sorted(SRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the compiles in parallel; raise with the compiler's output
    if any fails, else return it (ptxas's register/spill report)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs, failures = [], []
    for cmd, proc in zip(cmds, procs):
        output, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{output}")
        if proc.returncode != 0:
            failures.append(logs[-1])
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return "\n".join(logs)


def build() -> Path:
    """Compile ``csrc/*.cu`` into the hashed shared library (if it is
    not already there) and return its path."""
    so_path = BUILD_DIR / f"libkft_kernels_{_source_hash()}.so"
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    include = ["-I", str(SRC_DIR)]
    extra = ["-Xptxas", "-v"]  # registers and spills, into nvcc.log
    objects = []
    cmds = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{os.getpid()}.o"
        objects.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, *include, *extra, "-c", str(src),
                     "-o", str(obj)])
    report = _run_all(cmds)
    tmp = BUILD_DIR / f"{so_path.name}.tmp.{os.getpid()}"
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objects)]])
    log_tmp = BUILD_DIR / f"nvcc.log.tmp.{os.getpid()}"
    log_tmp.write_text(report)
    os.replace(log_tmp, BUILD_DIR / "nvcc.log")
    os.replace(tmp, so_path)  # atomic: a reader never sees half a file
    for obj in objects:
        obj.unlink(missing_ok=True)
    return so_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kft_error_string.argtypes = [ctypes.c_int]
            lib.kft_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(status: int, kernel: str) -> None:
    """Raise when a launch returned a non-zero CUDA status."""
    if status != 0:
        message = library().kft_error_string(status).decode()
        raise RuntimeError(f"{kernel} launch failed ({status}): {message}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as a raw handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(kernel: str, *tensors, word_reads=()) -> None:
    """A CUDA call site must hand the kernel tensors on one card,
    contiguous and aligned; anything else raises (there is no silent
    fallback on the card). ``tensors`` take 16-byte copies and need
    16-byte alignment. ``word_reads`` are tensors the kernel reads one
    4-byte word at a time (the f32 scales), which need only 4: a layer's
    slice of a stacked scale buffer starts wherever the layers before it
    end."""
    device = tensors[0].device
    for t, align in ([(t, 16) for t in tensors]
                     + [(t, 4) for t in word_reads]):
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{kernel}: the kernel takes CUDA tensors, got "
                             f"one on {t.device}")
        if t.device != device:
            raise ValueError(f"{kernel}: tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: inputs must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{kernel}: inputs must be {align}-byte "
                             "aligned")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()

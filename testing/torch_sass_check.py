#!/usr/bin/env python3
"""Count the tensor-core instructions in the port's built kernels.

Builds the kernel library (``kubeflow_tpu_torch/ops/_build.py``) and reads
its SASS with ``cuobjdump -sass``: prints, for every kernel instance, how
many HGMMA (wgmma) and HMMA (mma.sync) instructions it holds, and exits 1
when an instance of a flash kernel (``flash_fwd_kernel``,
``flash_dq_kernel``, ``flash_dkv_kernel``) or of decode attention
(``decode_attention_kernel``) holds none. Instances are named by their
template arguments (``flash_fwd_kernel<128>``: head dim 128;
``decode_attention_kernel<128,int8>``: head dim 128, an int8 cache).
Run from the root of a checkout on a machine with the CUDA toolkit:
``python3 testing/torch_sass_check.py``.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from kubeflow_tpu_torch.ops import _build  # noqa: E402

TENSOR_CORE_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel",
                       "flash_dkv_kernel", "decode_attention_kernel")
# Mangled template arguments: an int, or one of these types.
TYPES = {"13__nv_bfloat16": "bf16", "a": "int8"}


def main() -> int:
    library = _build.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    counts: dict[str, dict[str, int]] = {}
    name = None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            # mangled: ...<length><name>I<args>E..., each argument
            # Li<int>E or a type (13__nv_bfloat16, a for int8_t)
            short = re.search(r"(?<![a-z])([a-z]+(?:_[a-z]+)*_kernel)"
                              r"(?:I((?:Li\d+E|13__nv_bfloat16|a)+)E)?",
                              found.group(1))
            name = found.group(1)
            if short:
                args = [TYPES.get(tok, tok.strip("LiE")) for tok in
                        re.findall(r"Li\d+E|13__nv_bfloat16|a",
                                   short.group(2) or "")]
                name = short.group(1) + (f"<{','.join(args)}>"
                                         if args else "")
            counts[name] = {"HGMMA": 0, "HMMA": 0}
            continue
        for op in ("HGMMA", "HMMA"):
            if name and re.search(rf"\b{op}\.", line):
                counts[name][op] += 1
    missing = [n for n, c in counts.items()
               if any(k in n for k in TENSOR_CORE_KERNELS)
               and c["HGMMA"] + c["HMMA"] == 0]
    print(json.dumps({"kernels": counts, "without_tensor_cores": missing},
                     indent=1))
    return 1 if missing or not counts else 0


if __name__ == "__main__":
    sys.exit(main())

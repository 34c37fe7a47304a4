"""Hand-written Hopper kernels of the PyTorch port and their plain twins.

Each kernel module holds a wrapper that launches the CUDA kernel on a
CUDA tensor (or raises) and runs the plain PyTorch version beside it on
a CPU tensor. Ring attention belongs to a later slice.
"""

from kubeflow_tpu_torch.ops.attention import (
    apply_rope,
    flash_attention,
    flash_dkv,
    flash_dq,
    flash_forward,
    mha_reference,
)

__all__ = [
    "flash_attention",
    "flash_forward",
    "flash_dq",
    "flash_dkv",
    "mha_reference",
    "apply_rope",
]

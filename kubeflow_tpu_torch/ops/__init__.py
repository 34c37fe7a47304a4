"""Hand-written Hopper kernels of the PyTorch port and their plain twins.

Each kernel module holds a wrapper that launches the CUDA kernel on a
CUDA tensor (or raises) and runs the plain PyTorch version beside it on
a CPU tensor. ``cross_entropy`` and ``ring`` hold no kernel: the vocab-tiled
loss and ring attention's hops are torch products, as the reference's
are XLA outside any Pallas kernel.
"""

from kubeflow_tpu_torch.ops.attention import (
    apply_rope,
    flash_attention,
    flash_dkv,
    flash_dq,
    flash_forward,
    mha_reference,
)
from kubeflow_tpu_torch.ops.cross_entropy import (
    fused_ce,
    fused_lm_loss,
    next_token_targets,
)
from kubeflow_tpu_torch.ops.ring import make_ring_attention, ring_attention

__all__ = [
    "flash_attention",
    "flash_forward",
    "flash_dq",
    "flash_dkv",
    "mha_reference",
    "apply_rope",
    "fused_ce",
    "fused_lm_loss",
    "next_token_targets",
    "ring_attention",
    "make_ring_attention",
]

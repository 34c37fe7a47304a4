"""PyTorch/CUDA port of the platform's compute stack, for one NVIDIA
H100.

The JAX package ``kubeflow_tpu`` stays the reference; this package sits
beside it, imports ``torch``, numpy and the standard library only, and
mirrors the reference's module layout and public names. Every Pallas
kernel on a ported path is a CUDA C++ kernel for ``sm_90a`` under
``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``); each
wrapper runs its plain PyTorch twin on CPU tensors. Entry points run on
the card unless the caller passes ``device="cpu"``.

The first slice serves the LM: ops (flash prefill, GEMV, fused
QKV+RoPE, flash-decode), the model, KV-cache decode, the continuous
batcher and the streaming engine. The second trains it: the flash
forward with its logsumexp and the two backward kernels (dq, dk/dv)
behind a differentiable ``flash_attention``, the LM loss, AdamW with a
bf16 first moment, the train state and step.
"""

from kubeflow_tpu_torch._device import kernels_available, resolve_device

__all__ = ["kernels_available", "resolve_device"]

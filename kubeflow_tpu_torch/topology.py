"""The MFU denominator: a card's dense bf16 peak from its device name.

The counterpart of ``kubeflow_tpu/topology.py``'s
``peak_flops_for_device_kind``, which maps a TPU's ``device_kind`` to its
generation's peak. The port runs on NVIDIA cards and keeps only this one
table, keyed by ``torch.cuda.get_device_name()``; the TPU generations and
their slice topologies stay the JAX package's.
"""

from __future__ import annotations

# Dense (no 2:4 sparsity) bf16 tensor-core peak FLOP/s per card, from
# the vendor's data sheet, by the name torch reports for the card.
PEAK_BF16_FLOPS: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 989e12,   # H100 SXM5
}

# MFU denominator off the card (CPU test runs, a card not in the table):
# a nominal finite value so step telemetry stays well defined. MFU
# against it means nothing; it is no device's peak.
NOMINAL_PEAK_FLOPS = 1e12


def peak_flops_for_device_name(name: str | None,
                               default: float = NOMINAL_PEAK_FLOPS) -> float:
    """Dense bf16 peak FLOP/s of the card called ``name`` (as
    ``torch.cuda.get_device_name`` gives it), or ``default``."""
    return PEAK_BF16_FLOPS.get((name or "").strip(), default)


def device_name(device=None) -> str:
    """``torch.cuda.get_device_name`` of a CUDA ``device`` (the current
    card when None and one is present); ``"cpu"`` otherwise."""
    import torch

    device = torch.device(device) if device is not None else None
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda")
    if device is None or device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


__all__ = ["NOMINAL_PEAK_FLOPS", "PEAK_BF16_FLOPS", "device_name",
           "peak_flops_for_device_name"]

"""One module a kind of run; a mix's ``driver`` names it. Each has
``run(ctx) -> harness.Outcome`` and, for the precision control,
``control(ctx, seeds)``."""

from __future__ import annotations

import torch


def sync_fn(device):
    """A callable that waits for ``device`` (nothing on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def memory_peak(device) -> int:
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

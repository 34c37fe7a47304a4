"""The card's peaks, from NVIDIA's H100 SXM data sheet (dense rates,
no 2:4 sparsity), at its full power limit of 700 W.

A roofline share or an MFU is stated against these; the run records
the card's name beside it, and PERF.md its power limit.
"""

# bf16 tensor-core peak, FLOP/s.
PEAK_FLOPS = 989e12
# HBM3 bandwidth, bytes/s.
PEAK_BYTES = 3.35e12

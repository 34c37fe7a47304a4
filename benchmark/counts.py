"""The benchmark's own counts of operations and bytes, from shapes.

Work is the algorithm's, not an implementation's: attention counts the
live (query, key) pairs inside each document (a row attends to itself
and to the rows before it in its own segment), and a backward that
recomputes the scores is not paid for. Each input byte is read once and
each output byte written once. So a share of a roofline reads the same
whatever implements the layer, and cannot pass 100% unless the time
leaves out part of the work.
"""

from __future__ import annotations

from benchmark.peaks import PEAK_BYTES, PEAK_FLOPS

BF16 = 2
F32 = 4


def causal_pairs(n: int) -> int:
    """Live pairs of one causal document of ``n`` tokens."""
    return n * (n + 1) // 2


def live_pairs(segment_lengths) -> int:
    return sum(causal_pairs(int(n)) for n in segment_lengths)


def lm_product_params(cfg: dict) -> int:
    """Parameters that take part in a product for every token: each
    block's q, k, v, output and FFN kernels, and the tied head."""
    d, kv = cfg["dim"], cfg["kv_heads"] * cfg["head_dim"]
    block = 2 * d * d + 2 * d * kv + 2 * d * cfg["mlp_ratio"] * d
    return cfg["layers"] * block + cfg["vocab"] * d


def lm_train_flops(cfg: dict, tokens: int, pairs: int) -> float:
    """Forward and backward of ``tokens`` tokens whose documents hold
    ``pairs`` live pairs: 6 x product parameters x tokens, plus 12 x
    layers x dim per pair (4 x dim forward: scores and values)."""
    return (6.0 * lm_product_params(cfg) * tokens
            + 12.0 * cfg["layers"] * cfg["dim"] * pairs)


def flash_forward_work(cfg: dict, batch: int, seq: int,
                       pairs: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one layer's attention forward over a (batch,
    seq) block whose documents hold ``pairs`` live pairs: 4 x dim a
    pair; q, k, v and the output in bf16 and the f32 log-sum-exp, once
    each."""
    q = batch * seq * cfg["heads"] * cfg["head_dim"] * BF16
    kv = batch * seq * cfg["kv_heads"] * cfg["head_dim"] * BF16
    lse = batch * seq * cfg["heads"] * F32
    return 4.0 * cfg["dim"] * pairs, float(2 * q + 2 * kv + lse)


def flash_backward_work(cfg: dict, batch: int, seq: int,
                        pairs: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one layer's attention backward: 8 x dim a pair
    (dV, dP, dQ, dK; the recomputed scores are the implementation's
    choice and not counted); q, k, v, the output, its gradient and the
    log-sum-exp read, dq, dk and dv written, once each."""
    q = batch * seq * cfg["heads"] * cfg["head_dim"] * BF16
    kv = batch * seq * cfg["kv_heads"] * cfg["head_dim"] * BF16
    lse = batch * seq * cfg["heads"] * F32
    return 8.0 * cfg["dim"] * pairs, float(4 * q + 4 * kv + lse)


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the work over
    the bf16 peak and the bytes over the bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def resnet_train_flops(cfg: dict, images: int) -> float:
    """3 x the forward's FLOPs an image (forward, and a backward of
    twice that), times the images."""
    return 3.0 * cfg["forward_flops_per_image"] * images

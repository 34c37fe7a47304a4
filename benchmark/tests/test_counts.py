"""Each count of operations and bytes against a case worked by hand."""

import pytest

from benchmark import counts, readers
from benchmark.peaks import PEAK_BYTES, PEAK_FLOPS

LM = {"vocab": 32768, "layers": 8, "dim": 1024, "heads": 8, "kv_heads": 8,
      "head_dim": 128, "mlp_ratio": 4}
SMALL = {"vocab": 10, "layers": 2, "dim": 4, "heads": 2, "kv_heads": 1,
         "head_dim": 2, "mlp_ratio": 2}


def test_pairs_count_each_document_causally():
    assert counts.causal_pairs(1) == 1
    assert counts.causal_pairs(4) == 10          # 1 + 2 + 3 + 4
    assert counts.live_pairs([4, 2, 1]) == 10 + 3 + 1


def test_product_parameters():
    # 8 blocks x (4 x 1024^2 attention + 8 x 1024^2 MLP) + the head.
    assert counts.lm_product_params(LM) == 8 * 12 * 1024 ** 2 + 32768 * 1024
    # dim 4, kv 2: q 16 + k 8 + v 8 + proj 16 + up 32 + down 32 = 112.
    assert counts.lm_product_params(SMALL) == 2 * 112 + 40


def test_train_flops():
    assert counts.lm_train_flops(SMALL, tokens=3, pairs=5) == (
        6 * 264 * 3 + 12 * 2 * 4 * 5)


def test_attention_work_is_the_minimal_algorithm():
    # batch 1, seq 2, pairs 3 on SMALL (dim 4, heads 2 x 2, kv 1 x 2).
    fwd, fwd_bytes = counts.flash_forward_work(SMALL, 1, 2, 3)
    bwd, bwd_bytes = counts.flash_backward_work(SMALL, 1, 2, 3)
    assert fwd == 4 * 4 * 3 and bwd == 8 * 4 * 3
    q, kv, lse = 2 * 4 * 2, 2 * 2 * 2, 2 * 2 * 4
    assert fwd_bytes == 2 * q + 2 * kv + lse
    assert bwd_bytes == 4 * q + 4 * kv + lse
    # Below what a backward recomputing the scores spends (6 + 8 per d).
    assert bwd < 14 * SMALL["dim"] * 3


def test_the_bound_is_the_larger_of_compute_and_bandwidth():
    assert counts.bound_seconds(PEAK_FLOPS, 0) == pytest.approx(1.0)
    assert counts.bound_seconds(0, PEAK_BYTES) == pytest.approx(1.0)
    assert counts.bound_seconds(PEAK_FLOPS, 2 * PEAK_BYTES) == \
        pytest.approx(2.0)


def test_resnet_flops():
    assert counts.resnet_train_flops({"forward_flops_per_image": 8.18e9},
                                     10) == pytest.approx(3 * 8.18e10)


def test_shares_are_none_without_time():
    assert readers.share_percent(1.0, 0.0) is None
    assert readers.share_percent(1.0, 4.0) == 25.0
    assert readers.mfu_percent(PEAK_FLOPS, 2.0) == 50.0

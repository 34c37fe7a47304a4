"""The port's CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA sm_90 card and skips without one (the
decision is taken inside the ``card`` fixture, never at import). The
file imports no JAX, so on the machine with the card it runs without
the JAX-bound conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances are element by element, |out - twin| <= rtol * |twin| +
atol * rms(twin row), the RMS over the last axis, so every row of an
attention output is held at its own scale: f32 outputs (1e-5, 1e-4)
(summation order only); bf16 outputs, attention included, (2^-7, 2^-5):
one ulp of the final rounding plus rounding at a different point inside
(softmax weights rounded to bf16 at a different normalisation); the
backward kernels' dq, dk and dv the same (p and ds round to bf16 at the
same points in kernel and twin, the sums run in another order); lse is
f32. A row's RMS is floored at ``ROW_RMS_FLOOR`` of the output's RMS: a
row whose exact value is zero (dq of a row with one live key, where p = 1
and dp = delta cancel) is f32 residue of ~1e-7 in kernel and twin alike,
different for each summation order, and is held at the output's scale. Greedy tokens are compared exactly; gradients through the kernels
against autograd through the f32 plain attention are held in relative
norm per tensor at ``TOL_GRAD_NORM`` (below).
"""

from __future__ import annotations

import pytest
import torch

pytestmark = pytest.mark.cuda

TOL_F32, TOL_BF16 = (1e-5, 1e-4), (2.0 ** -7, 2.0 ** -5)
ROW_RMS_FLOOR = 2.0 ** -8
# bf16 kernels vs f32 autograd: the kernel path rounds o, p and ds to
# bf16, and delta = rowsum(dO * O) from a bf16 O meets dp in dp - delta,
# where the two nearly cancel; so single elements can be off by far more
# than an ulp, while the whole tensor stays within a few bf16 ulps
# (2^-8) in relative norm.
TOL_GRAD_NORM = 2e-2


@pytest.fixture
def card():
    from kubeflow_tpu_torch import kernels_available

    if not kernels_available():
        pytest.skip("needs an NVIDIA card of compute capability 9.0")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, std=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * std).bfloat16()


def _assert_close(out, ref, tol):
    rtol, atol = tol
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    rms = torch.maximum(r.pow(2).mean(-1, keepdim=True).sqrt(),
                        ROW_RMS_FLOOR * r.pow(2).mean().sqrt())
    limit = rtol * r.abs() + atol * rms
    bad = ~(diff <= limit)   # NaN fails too
    assert not bad.any(), (
        f"{int(bad.sum())} elements outside rtol {rtol} + atol {atol} x row "
        f"rms; max_abs_err {float(diff.max())}")


@pytest.mark.parametrize("case", ["plain", "residual", "transpose",
                                  "int8", "int8_transpose_residual"])
def test_gemv_kernel_matches_twin(card, case):
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops.gemv import gemv, gemv_reference

    rows, k, n = 5, 512, 768
    transpose = "transpose" in case
    x = _randn(card, rows, k)
    w = _randn(card, *((n, k) if transpose else (k, n)), std=k ** -0.5)
    scale = res = None
    if "int8" in case:
        axis = 1 if transpose else 0
        scale = w.float().abs().amax(dim=axis) / 127.0
        w = torch.round(w.float() / scale.unsqueeze(axis)).to(torch.int8)
    if "residual" in case:
        res = _randn(card, rows, n)
    before = _build.LAUNCHES["gemv"]
    out = gemv(x, w, scale, res, transpose_w=transpose)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gemv"] == before + 1
    _assert_close(out, gemv_reference(x, w, scale, res,
                                      transpose_w=transpose),
                  TOL_BF16 if res is not None else TOL_F32)


# (rows, k, n, residual, transpose, int8): the flagship's decode shapes,
# and ragged ones: a column tile cut by N (n % 32 != 0), a K slice that
# ends inside a staged chunk, a K that is no multiple of the (N, K)
# kernel's staged chunk, a K too short to split (one block finishes every
# output of its tile).
GEMV_SHAPES = {
    "proj_residual": (8, 1024, 1024, True, False, False),
    "down_residual": (8, 4096, 1024, True, False, False),
    "up": (8, 1024, 4096, False, False, False),
    "tied_head": (8, 1024, 32768, False, True, False),
    "ragged_tile_and_slice": (3, 1040, 4112, False, False, False),
    "int8_ragged": (7, 1040, 2064, True, False, True),
    "transpose_ragged_k": (2, 1552, 272, True, True, False),
    "one_slice": (4, 64, 8208, True, False, False),
}


def _gemv_inputs(gen, case):
    rows, k, n, residual, transpose, int8 = GEMV_SHAPES[case]
    x = _randn(gen, rows, k)
    w = _randn(gen, *((n, k) if transpose else (k, n)), std=k ** -0.5)
    scale = None
    if int8:
        axis = 1 if transpose else 0
        scale = w.float().abs().amax(dim=axis) / 127.0
        w = torch.round(w.float() / scale.unsqueeze(axis)).to(torch.int8)
    res = _randn(gen, rows, n) if residual else None
    return (x, w, scale, res), dict(transpose_w=transpose)


@pytest.mark.parametrize("case", sorted(GEMV_SHAPES))
def test_gemv_kernel_at_decode_and_ragged_shapes(card, case):
    from kubeflow_tpu_torch.ops.gemv import gemv, gemv_reference

    args, kw = _gemv_inputs(card, case)
    out = gemv(*args, **kw)
    torch.cuda.synchronize()
    _assert_close(out, gemv_reference(*args, **kw),
                  TOL_BF16 if args[3] is not None else TOL_F32)


@pytest.mark.parametrize("case", ["tied_head", "down_residual"])
def test_gemv_kernel_is_deterministic(card, case):
    """No atomics: the K slices meet in a fixed order, so two launches
    give the same bits."""
    from kubeflow_tpu_torch.ops.gemv import gemv

    args, kw = _gemv_inputs(card, case)
    first, second = gemv(*args, **kw), gemv(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# (rows, k, head_dim, heads, kv_heads, int8): every column written at one
# and eight rows, at head dims whose half takes 16-byte loads (128, 256,
# 16 in bf16), 8-byte (40 in bf16, 16 in int8) or single-element ones (an
# odd half), with int8 weights, and with a K that is no multiple of 8
# (activations staged one element a load).
QKV_CASES = {
    "hd128": (3, 256, 128, 8, 2, False),
    "hd40": (3, 256, 40, 3, 1, False),
    "hd16": (3, 256, 16, 4, 2, False),
    "one_row_flagship": (1, 1024, 128, 8, 2, False),
    "eight_rows_flagship": (8, 1024, 128, 8, 2, False),
    "eight_rows_hd256": (8, 512, 256, 4, 2, False),
    "one_row_hd40": (1, 256, 40, 3, 1, False),
    "eight_rows_hd16": (8, 256, 16, 4, 2, False),
    "int8_flagship": (8, 1024, 128, 8, 2, True),
    "int8_hd40": (5, 256, 40, 3, 1, True),
    "int8_hd16_one_row": (1, 256, 16, 4, 2, True),
    "odd_half": (4, 96, 6, 3, 1, False),
    "k_not_multiple_of_8": (6, 100, 64, 4, 2, True),
}


def _qkv_inputs(gen, case, rows=None):
    n_rows, k, hd, heads, kv, int8 = QKV_CASES[case]
    rows = rows or n_rows
    n = (heads + 2 * kv) * hd
    x = _randn(gen, rows, k)
    w = _randn(gen, k, n, std=k ** -0.5)
    scale = None
    if int8:
        scale = w.float().abs().amax(dim=0) / 127.0
        w = torch.round(w.float() / scale).to(torch.int8)
    pos = torch.randint(0, 2048, (rows,), dtype=torch.int32, device="cuda",
                        generator=gen)
    return (x, w, pos, scale), dict(head_dim=hd, rope_heads=heads + kv)


@pytest.mark.parametrize("case", sorted(QKV_CASES))
def test_qkv_rope_kernel_writes_every_column(card, case):
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops.decode_qkv import qkv_rope, qkv_rope_reference

    args, kw = _qkv_inputs(card, case)
    before = _build.LAUNCHES["qkv_rope"]
    out = qkv_rope(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["qkv_rope"] == before + 1
    assert torch.isfinite(out.float()).all()
    _assert_close(out, qkv_rope_reference(*args, **kw), TOL_BF16)


@pytest.mark.parametrize("case", ["eight_rows_flagship", "int8_flagship",
                                  "hd40"])
def test_qkv_rope_kernel_is_deterministic(card, case):
    """The K slices meet in rank order, no atomics: two launches give the
    same bits."""
    from kubeflow_tpu_torch.ops.decode_qkv import qkv_rope

    args, kw = _qkv_inputs(card, case)
    first, second = qkv_rope(*args, **kw), qkv_rope(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("case", ["eight_rows_flagship", "int8_flagship",
                                  "hd40"])
def test_qkv_rope_kernel_is_batch_invariant(card, case):
    """Each row alone (one row, its own position) gives the same bits as
    its row of the eight-row call: the K split depends on K and N only."""
    from kubeflow_tpu_torch.ops.decode_qkv import qkv_rope

    (x, w, pos, scale), kw = _qkv_inputs(card, case, rows=8)
    batch = qkv_rope(x, w, pos, scale, **kw)
    rows = [qkv_rope(x[i:i + 1].clone(), w, pos[i:i + 1].clone(), scale, **kw)
            for i in range(8)]
    torch.cuda.synchronize()
    assert torch.equal(batch, torch.cat(rows))


# (int8, rolling, window, capacity, head_dim, heads, kv_heads, positions):
# the first five at head dim 64 with positions (0, 17, cap - 1, 200 or a
# wrapped ring position); then every head dim and groups 1, 4 and 8;
# capacity 2048 with rows of fewer live positions than the kernel's 8
# slices (0, 1, 7: empty slices), slices of unequal length and pos = cap
# - 1; capacities that are no multiple of a tile (1280, 1000); int8 and
# rolling at capacity >= 512, int8 at the 32-byte rows of head dim 32; a
# window that starts inside a tile.
DECODE_CASES = {
    "linear": (False, False, None, 300, 64, 8, 2, None),
    "int8": (True, False, None, 300, 64, 8, 2, None),
    "window": (False, False, 64, 300, 64, 8, 2, None),
    "rolling": (False, True, 128, 128, 64, 8, 2, None),
    "int8_rolling": (True, True, 128, 128, 64, 8, 2, None),
    "hd128_group4_cap2048": (False, False, None, 2048, 128, 8, 2,
                             (0, 1, 7, 2047, 1086, 318, 9, 1500)),
    "hd32_group1_cap1000": (False, False, None, 1000, 32, 2, 2,
                            (0, 5, 999, 640, 8)),
    "hd256_group8_cap1280": (False, False, None, 1280, 256, 8, 1,
                             (0, 1279, 700, 15)),
    "hd64_group8_cap1000": (False, False, None, 1000, 64, 16, 2,
                            (3, 999, 57, 421)),
    "int8_hd128_cap1280": (True, False, None, 1280, 128, 8, 2,
                           (0, 1, 7, 1279, 513, 1000, 64, 65)),
    "int8_hd32_cap1000": (True, False, None, 1000, 32, 4, 1,
                          (0, 999, 31, 500)),
    "int8_hd256_cap512": (True, False, None, 512, 256, 4, 2, (511, 2, 260)),
    "rolling_cap512": (False, True, 512, 512, 128, 8, 2,
                       (0, 100, 511, 512, 700, 1279, 2000, 333)),
    "int8_rolling_cap1000": (True, True, 1000, 1000, 64, 4, 1,
                             (3, 999, 1000, 2500)),
    "window_inside_a_tile": (False, False, 300, 2048, 128, 8, 2,
                             (1500, 250, 299, 300, 2047, 301)),
}


def _decode_inputs(gen, case, positions=None):
    int8, rolling, window, cap, hd, h, hkv, pos = DECODE_CASES[case]
    if pos is None:
        pos = (0, 17, cap - 1, 3 * cap + 5 if rolling else 200)
    pos = positions or pos
    b = len(pos)
    q = _randn(gen, b, h, 1, hd)
    kc, vc = _randn(gen, b, hkv, cap, hd), _randn(gen, b, hkv, cap, hd)
    ks = vs = None
    if int8:
        ks = kc.float().abs().amax(-1, keepdim=True) / 127.0
        vs = vc.float().abs().amax(-1, keepdim=True) / 127.0
        kc = torch.round(kc.float() / ks).to(torch.int8)
        vc = torch.round(vc.float() / vs).to(torch.int8)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return (q, kc, vc, pos), dict(window=window, k_scale=ks, v_scale=vs,
                                  rolling=rolling)


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_kernel_matches_twin(card, case):
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_reference,
    )

    args, kw = _decode_inputs(card, case)
    before = _build.LAUNCHES["decode_attention"]
    out = decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_attention"] == before + 1
    _assert_close(out, decode_attention_reference(*args, **kw), TOL_BF16)


@pytest.mark.parametrize("case", ["hd128_group4_cap2048",
                                  "int8_hd128_cap1280", "rolling_cap512"])
def test_decode_attention_kernel_is_deterministic(card, case):
    """The slices meet in rank order, no atomics: two launches give the
    same bits."""
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention

    args, kw = _decode_inputs(card, case)
    first, second = decode_attention(*args, **kw), decode_attention(*args,
                                                                    **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("case", ["hd128_group4_cap2048",
                                  "int8_hd128_cap1280", "rolling_cap512",
                                  "window_inside_a_tile"])
def test_decode_attention_kernel_is_batch_invariant(card, case):
    """Each row alone, at B=1 and its own position, gives the same bits as
    its row of the batched call: a row's slices depend on its own live
    range only (the engine decodes at B=8, generate() at B=1)."""
    from kubeflow_tpu_torch.ops.decode_attention import decode_attention

    (q, kc, vc, pos), kw = _decode_inputs(card, case)
    batch = decode_attention(q, kc, vc, pos, **kw)
    rows = []
    for i in range(q.shape[0]):
        one = {key: (val[i:i + 1].clone()
                     if isinstance(val, torch.Tensor) else val)
               for key, val in kw.items()}
        rows.append(decode_attention(q[i:i + 1].clone(),
                                     kc[i:i + 1].clone(),
                                     vc[i:i + 1].clone(),
                                     pos[i:i + 1].clone(), **one))
    torch.cuda.synchronize()
    assert torch.equal(batch, torch.cat(rows))


@pytest.mark.parametrize("causal,window,segmented,sq", [
    (True, None, False, 200), (True, 48, False, 256), (False, None, False, 96),
    (True, None, True, 160)])
def test_flash_kernel_matches_twin(card, causal, window, segmented, sq):
    from kubeflow_tpu_torch.ops.attention import flash_attention, mha_reference

    q = _randn(card, 2, 4, sq, 64)
    k, v = _randn(card, 2, 2, sq, 64), _randn(card, 2, 2, sq, 64)
    seg = None
    if segmented:
        seg = torch.sort(torch.randint(0, 3, (2, sq), device="cuda",
                                       generator=card), dim=1).values
    out = flash_attention(q, k, v, causal=causal, window=window,
                          segment_ids=seg)
    torch.cuda.synchronize()
    _assert_close(out, mha_reference(q, k, v, causal=causal, window=window,
                                     segment_ids=seg), TOL_BF16)


# (causal, window, segments, heads, kv_heads, sq, sk, head_dim). segments:
# False, True (random sorted ids), or the positions where a new document
# starts. Every head dim the kernels are built for appears, each on a
# ragged length (not a multiple of the 64-row tile).
BACKWARD_CASES = {
    "causal": (True, None, False, 4, 4, 256, 256, 64),
    "gqa": (True, None, False, 8, 2, 320, 320, 128),
    "window": (True, 48, False, 4, 2, 256, 256, 64),
    "segments": (True, None, True, 4, 2, 288, 288, 64),
    "non_causal": (False, None, False, 4, 2, 200, 200, 64),
    "ragged_window": (True, 256, False, 2, 2, 1000, 1000, 128),
    "head_dim_16": (True, None, False, 4, 2, 200, 200, 16),
    "head_dim_32": (True, 40, False, 2, 1, 130, 130, 32),
    "head_dim_256": (True, None, False, 4, 2, 160, 160, 256),
    "head_dim_256_mha": (False, None, False, 2, 2, 100, 100, 256),
    "non_causal_sq_ne_sk": (False, None, False, 4, 2, 200, 333, 64),
    "segments_mid_tile": (True, None, (37, 100, 170, 230), 4, 2, 288, 288,
                          128),
}


def _backward_inputs(gen, case, cases=BACKWARD_CASES):
    causal, window, segments, h, hkv, sq, sk, d = cases[case]
    q = _randn(gen, 2, h, sq, d)
    k, v = _randn(gen, 2, hkv, sk, d), _randn(gen, 2, hkv, sk, d)
    do = _randn(gen, 2, h, sq, d)
    seg = None
    if segments is True:
        seg = torch.sort(torch.randint(0, 4, (2, sq), device="cuda",
                                       generator=gen), dim=1).values
    elif segments:
        starts = torch.tensor(segments, device="cuda")
        ids = torch.searchsorted(starts, torch.arange(sq, device="cuda"),
                                 right=True)
        seg = ids.to(torch.int32)[None].repeat(2, 1)
    return q, k, v, do, dict(causal=causal, window=window, segment_ids=seg)


# Sq > Sk under a window: rows from Sk - 1 + window on see no key.
NO_LIVE_KEY_CASE = {"window_sq_gt_sk": (True, 64, False, 4, 2, 300, 130, 128)}
FORWARD_CASES = {**BACKWARD_CASES,
                 "sq_gt_sk_window": NO_LIVE_KEY_CASE["window_sq_gt_sk"]}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_flash_forward_lse_matches_twin(card, case):
    """o and lse against the twin. Rows with no live key (the
    sq_gt_sk_window case) must be exactly o = 0 and lse = -1e30 in both;
    lse is compared on the other rows (a -1e30 would set the row RMS)."""
    from kubeflow_tpu_torch.ops.attention import (
        NEG_INF,
        flash_forward,
        flash_forward_reference,
    )

    q, k, v, _, kw = _backward_inputs(card, case, FORWARD_CASES)
    o, lse = flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_forward_reference(q, k, v, **kw)
    _assert_close(o, o_ref, TOL_BF16)
    dead = lse_ref == NEG_INF
    if case == "sq_gt_sk_window":
        first_dead = k.shape[2] - 1 + kw["window"]
        assert bool(dead[:, :, first_dead:].all())
        assert not bool(dead[:, :, :first_dead].any())
    assert torch.equal(lse[dead], lse_ref[dead])
    assert torch.count_nonzero(o[dead]) == 0
    zero = torch.zeros_like(lse)
    _assert_close(torch.where(dead, zero, lse),
                  torch.where(dead, zero, lse_ref), TOL_F32)


@pytest.mark.parametrize("case", sorted(BACKWARD_CASES))
def test_flash_backward_kernels_match_twins(card, case):
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops.attention import (
        flash_dkv,
        flash_dkv_reference,
        flash_dq,
        flash_dq_reference,
        flash_forward_reference,
    )

    q, k, v, do, kw = _backward_inputs(card, case)
    o, lse = flash_forward_reference(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    before = dict(_build.LAUNCHES)
    dq = flash_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_dq"] == before["flash_dq"] + 1
    assert _build.LAUNCHES["flash_dkv"] == before["flash_dkv"] + 1
    _assert_close(dq, flash_dq_reference(q, k, v, do, lse, delta, **kw),
                  TOL_BF16)
    dk_ref, dv_ref = flash_dkv_reference(q, k, v, do, lse, delta, **kw)
    _assert_close(dk, dk_ref, TOL_BF16)
    _assert_close(dv, dv_ref, TOL_BF16)


def test_flash_backward_rows_without_live_keys_get_zero_gradient(card):
    """Rows with no live key get exactly zero dq (p is masked, not left to
    underflow), and every output still matches its twin."""
    from kubeflow_tpu_torch.ops.attention import (
        flash_dkv,
        flash_dkv_reference,
        flash_dq,
        flash_dq_reference,
        flash_forward_reference,
    )

    q, k, v, do, kw = _backward_inputs(card, "window_sq_gt_sk",
                                       NO_LIVE_KEY_CASE)
    o, lse = flash_forward_reference(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    dq = flash_dq(*args, **kw)
    dk, dv = flash_dkv(*args, **kw)
    torch.cuda.synchronize()
    first_dead = k.shape[2] - 1 + kw["window"]
    assert first_dead < q.shape[2]
    assert torch.count_nonzero(dq[:, :, first_dead:]) == 0
    assert torch.count_nonzero(dq[:, :, :first_dead]) > 0
    _assert_close(dq, flash_dq_reference(*args, **kw), TOL_BF16)
    dk_ref, dv_ref = flash_dkv_reference(*args, **kw)
    _assert_close(dk, dk_ref, TOL_BF16)
    _assert_close(dv, dv_ref, TOL_BF16)


def test_flash_backward_kernels_are_deterministic(card):
    """No atomics: every output element is owned by one block and summed
    in one fixed order, so two launches give the same bits."""
    from kubeflow_tpu_torch.ops.attention import (
        flash_dkv,
        flash_dq,
        flash_forward,
    )

    q, k, v, do, kw = _backward_inputs(card, "gqa")
    o, lse = flash_forward(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    first = (flash_dq(q, k, v, do, lse, delta, **kw),
             *flash_dkv(q, k, v, do, lse, delta, **kw))
    second = (flash_dq(q, k, v, do, lse, delta, **kw),
              *flash_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["causal", "gqa", "segments"])
def test_gradients_through_flash_match_autograd_of_plain_attention(card,
                                                                   case):
    from kubeflow_tpu_torch.ops.attention import flash_attention, mha_reference

    q, k, v, do, kw = _backward_inputs(card, case)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, do)
    plain = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref = mha_reference(*plain, **kw)
    ref_grads = torch.autograd.grad(ref, plain, do.float())
    torch.cuda.synchronize()
    _assert_close(out, ref, TOL_BF16)
    for g, r in zip(grads, ref_grads):
        assert g.dtype == torch.bfloat16
        err = float((g.float() - r).norm() / r.norm())
        assert err <= TOL_GRAD_NORM, err


def test_train_step_on_the_card_lowers_the_loss(card):
    """A 2-layer bf16 LM takes six steps on one batch through the flash
    kernels: every step launches forward, dq and dk/dv once per layer,
    and the loss falls."""
    from kubeflow_tpu_torch.models import (
        LMConfig,
        build_lm,
        create_lm_state,
        make_lm_train_step,
    )
    from kubeflow_tpu_torch.ops import _build

    cfg = LMConfig(vocab=512, layers=2, dim=256, heads=4,
                   dtype=torch.bfloat16)
    state = create_lm_state(build_lm(cfg), seed=2)
    step = make_lm_train_step(cfg=cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 128), device="cuda",
                           generator=card)
    _build.reset_launches()
    losses = [float(step(state, {"tokens": tokens})[1]["loss"])
              for _ in range(6)]
    for name in ("flash_attention", "flash_dq", "flash_dkv"):
        assert _build.LAUNCHES[name] == 6 * cfg.layers, _build.LAUNCHES
    assert all(map(lambda x: x == x, losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("dtype,dim,heads", [(torch.float32, 256, 4),
                                             (torch.bfloat16, 192, 2)],
                         ids=["f32", "head_dim_96"])
def test_build_lm_auto_raises_on_the_card_for_what_no_kernel_takes(
        card, dtype, dim, heads):
    """The default core takes the kernels for every CUDA tensor: an f32
    config, or a head dim the kernels were not built for, raises instead
    of training on the plain path."""
    from kubeflow_tpu_torch.models import LMConfig, build_lm, create_lm_state
    from kubeflow_tpu_torch.ops import _build

    cfg = LMConfig(vocab=64, layers=1, dim=dim, heads=heads, dtype=dtype)
    state = create_lm_state(build_lm(cfg), seed=0)
    tokens = torch.zeros(1, 32, dtype=torch.long, device="cuda")
    _build.reset_launches()
    with pytest.raises((TypeError, ValueError), match="bf16|head dims"):
        state.apply_fn(state.params, tokens)
    assert _build.LAUNCHES["flash_attention"] == 0


def test_row_wise_ops_are_batch_invariant_on_the_card(card):
    """The decode step's PyTorch ops between kernels give each row the
    same bits whatever the batch: what lets the batched engine match
    single-request generate() exactly on the card."""
    from kubeflow_tpu_torch.models.transformer import gelu, rms_norm

    x = _randn(card, 8, 1, 1024)
    scale = torch.rand(1024, generator=card, device="cuda") + 0.5
    rows = lambda fn, t: torch.cat([fn(t[i:i + 1])  # noqa: E731
                                    for i in range(t.shape[0])])
    norm = lambda t: rms_norm(scale, t)  # noqa: E731
    assert torch.equal(norm(x), rows(norm, x))
    h = _randn(card, 8, 1, 4096)
    assert torch.equal(gelu(h), rows(gelu, h))


def test_engine_on_the_card_matches_generate(card):
    """A tiny bf16 model served through the streaming engine on the card:
    every kernel launches, and greedy streams equal generate()."""
    from kubeflow_tpu_torch.models.decoding import generate
    from kubeflow_tpu_torch.models.transformer import LMConfig, init_params
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.serving import make_engine

    cfg = LMConfig(vocab=512, layers=2, dim=256, heads=4, kv_heads=2,
                   dtype=torch.bfloat16)
    params = init_params(cfg, seed=1, device="cuda", dtype=torch.bfloat16)
    engine = make_engine(cfg, params, max_batch=4, max_len=256)
    prompts = [list(range(3, 3 + n)) for n in (40, 17, 64)]
    outs = {}
    _build.reset_launches()
    for i, p in enumerate(prompts):
        engine.submit_stream(p, lambda e, i=i: outs.__setitem__(i, e)
                             if e.get("done") else None, max_new_tokens=12)
    engine.drain()
    serving = ("flash_attention", "gemv", "qkv_rope", "decode_attention")
    assert all(_build.LAUNCHES[n] > 0 for n in serving), _build.LAUNCHES
    for i, p in enumerate(prompts):
        ref = generate(cfg, params, [p], 12)[0].tolist()
        assert outs[i]["tokens"] == ref


# Card vs CPU twins on the same bf16 model: both round to bf16 at the
# same points and sum in other orders, so logits of |x| ~ 3 (bf16 ulp
# 2^-6) agree to a few ulps.
TOL_LOGITS_TWINS = 0.1


@pytest.mark.parametrize("kv_heads,prompt_len,new", [(2, 8, 8),
                                                     (1, 248, 8)],
                         ids=["cap15_hkv2", "cap255_hkv1"])
def test_int8_cache_generate_at_unaligned_layer_offsets(card, monkeypatch,
                                                        kv_heads, prompt_len,
                                                        new):
    """An int8 KV cache whose per-layer scale slices start off a 16-byte
    boundary (capacity 15 at B=1, Hkv=2: layer 1 at 120 bytes; capacity
    255 at Hkv=1: layer 1 at 1020) decodes through flash-decode on the
    card and gives the tokens and first decode logits of the same call
    on CPU copies of the params, where every wrapper runs its twin."""
    from kubeflow_tpu_torch.models import decoding as tdec
    from kubeflow_tpu_torch.models.transformer import LMConfig, init_params
    from kubeflow_tpu_torch.ops import _build

    monkeypatch.setattr(tdec, "DECODE_MM", "gemv")
    monkeypatch.setattr(tdec, "DECODE_FUSED", "on")
    monkeypatch.setattr(tdec, "DECODE_IMPL", "kernel")
    cfg = LMConfig(vocab=512, layers=2, dim=256, heads=4, kv_heads=kv_heads,
                   dtype=torch.bfloat16)
    params = init_params(cfg, seed=1, device="cuda", dtype=torch.bfloat16)
    cpu = {k: {n: {leaf: t.cpu() for leaf, t in v.items()}
               if isinstance(v, dict) else v.cpu() for n, v in sub.items()}
           for k, sub in params.items()}
    prompt = [[(7 * i + 3) % cfg.vocab for i in range(prompt_len)]]
    cap = prompt_len + new - 1
    assert cap * kv_heads * 4 % 16, "the case must misalign layer 1"

    def first_decode_logits(p, device):
        cache = tdec.KVCache.init(cfg, 1, cap, quantized=True, device=device)
        logits, cache = tdec.forward_with_cache(cfg, p, prompt, cache,
                                                last_logits_only=True,
                                                device=device)
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        return tdec.forward_with_cache(cfg, p, nxt, cache, device=device)[0]

    _build.reset_launches()
    out = tdec.generate(cfg, params, prompt, new, quantize_cache=True)
    assert _build.LAUNCHES["decode_attention"] == cfg.layers * (new - 1)
    ref = tdec.generate(cfg, cpu, prompt, new, quantize_cache=True,
                        device="cpu")
    assert out.cpu().tolist() == ref.tolist()
    card_logits = first_decode_logits(params, "cuda").cpu()
    cpu_logits = first_decode_logits(cpu, "cpu")
    assert float((card_logits - cpu_logits).abs().max()) <= TOL_LOGITS_TWINS


@pytest.mark.parametrize("quantize_cache", [False, True])
def test_batched_generate_on_the_card_matches_the_cpu(card, quantize_cache):
    """``generate`` at batch 4 takes the last position of every row for
    the head (a strided view at B > 1) through the GEMV kernel: the
    tokens equal the same call on CPU copies of the params, where every
    wrapper runs its twin, and every serving kernel launched."""
    from kubeflow_tpu_torch.models import decoding as tdec
    from kubeflow_tpu_torch.models.transformer import LMConfig, init_params
    from kubeflow_tpu_torch.ops import _build

    cfg = LMConfig(vocab=512, layers=2, dim=256, heads=4, kv_heads=2,
                   dtype=torch.bfloat16)
    params = init_params(cfg, seed=2, device="cuda", dtype=torch.bfloat16)
    cpu = {k: {n: {leaf: t.cpu() for leaf, t in v.items()}
               if isinstance(v, dict) else v.cpu() for n, v in sub.items()}
           for k, sub in params.items()}
    prompt = [[(5 * i + 11 * row + 1) % cfg.vocab for i in range(24)]
              for row in range(4)]
    _build.reset_launches()
    out = tdec.generate(cfg, params, prompt, 6,
                        quantize_cache=quantize_cache)
    assert all(_build.LAUNCHES[name] for name in (
        "gemv", "qkv_rope", "decode_attention", "flash_attention"))
    ref = tdec.generate(cfg, cpu, prompt, 6, quantize_cache=quantize_cache,
                        device="cpu")
    assert out.cpu().tolist() == ref.tolist()


def _card_lm_state(seed):
    from kubeflow_tpu_torch.models import LMConfig, build_lm, create_lm_state

    cfg = LMConfig(vocab=512, layers=2, dim=256, heads=4,
                   dtype=torch.bfloat16)
    return cfg, create_lm_state(build_lm(cfg), seed=seed)


def _assert_states_equal(a, b):
    from kubeflow_tpu_torch.models.checkpoint import (
        _arrays_only,
        _flatten_keys,
    )

    la, lb = (dict(_flatten_keys(_arrays_only(s))) for s in (a, b))
    assert la.keys() == lb.keys()
    for key, leaf in la.items():
        if isinstance(leaf, torch.Tensor):
            assert leaf.is_cuda and lb[key].is_cuda, key
            assert leaf.dtype == lb[key].dtype, key
            assert torch.equal(leaf, lb[key]), key
        else:
            assert int(leaf) == int(lb[key]), key


def test_checkpoint_of_a_card_state_restores_bit_equal(card, tmp_path):
    """A trained state on the card saved and restored into a fresh card
    template (another seed): every leaf equal, on the card, in its dtype
    (f32 params that require grad, bf16 mu, f32 nu)."""
    from kubeflow_tpu_torch.models import make_lm_train_step
    from kubeflow_tpu_torch.models.checkpoint import CheckpointManager

    cfg, state = _card_lm_state(3)
    tokens = torch.randint(0, cfg.vocab, (2, 128), device="cuda",
                           generator=card)
    state, _ = make_lm_train_step(cfg=cfg)(state, {"tokens": tokens})
    mgr = CheckpointManager(tmp_path)
    mgr.save(state.step, state)
    _, like = _card_lm_state(4)
    restored, step = mgr.restore_latest_valid(like)
    assert step == 1 and restored.step == 1
    _assert_states_equal(restored, state)
    assert restored.params["embed"]["embedding"].requires_grad
    assert restored.opt_state.mu["embed"]["embedding"].dtype == torch.bfloat16


def test_async_snapshot_is_independent_of_the_next_in_place_step(card,
                                                                 tmp_path):
    """save_async returns once its host copy is taken; the step that
    follows writes the same tensors in place, and the committed step
    still holds the state as it was at the call."""
    from kubeflow_tpu_torch.models import make_lm_train_step
    from kubeflow_tpu_torch.models.checkpoint import CheckpointManager

    cfg, state = _card_lm_state(5)
    _, before = _card_lm_state(5)   # the same values, kept apart
    step = make_lm_train_step(cfg=cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 128), device="cuda",
                           generator=card)
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(0, state)
    for _ in range(3):
        state, _ = step(state, {"tokens": tokens})
    mgr.wait()
    _, like = _card_lm_state(6)
    restored, saved_step = mgr.restore_latest_valid(like)
    assert saved_step == 0 and state.step == 3
    _assert_states_equal(restored, before)


def test_stacked_and_rolling_chunk_decode_on_the_card(card):
    """On the card the stacked params give the per-layer form's bits
    (same kernels: the stacked qkv feeds the fused QKV+RoPE launch), and
    a windowed model fed to a rolling cache in chunks of 50 (the ring
    holds 64: every chunk after the first wraps it) ends on the logits
    that token-by-token decode (flash-decode on the ring) gives."""
    from kubeflow_tpu_torch.models import decoding as tdec
    from kubeflow_tpu_torch.models.transformer import LMConfig, init_params

    cfg = LMConfig(vocab=512, layers=2, dim=256, heads=4, kv_heads=2,
                   dtype=torch.bfloat16, attn_window=64)
    params = init_params(cfg, seed=7, device="cuda", dtype=torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab, (1, 40), device="cuda",
                           generator=card)
    stacked = tdec.stack_decode_params(cfg, params)
    assert torch.equal(tdec.generate(cfg, stacked, prompt, 8),
                       tdec.generate(cfg, params, prompt, 8))
    whole = tdec.KVCache.init(cfg, 1, 200, rolling=True)
    chunked = tdec.KVCache.init(cfg, 1, 200, rolling=True)
    tokens = torch.randint(0, cfg.vocab, (1, 150), device="cuda",
                           generator=card)
    ref, whole = tdec.forward_with_cache(cfg, params, tokens[:, :1], whole)
    for t in range(1, 150):
        ref, whole = tdec.forward_with_cache(cfg, params,
                                             tokens[:, t:t + 1], whole)
    for a in range(0, 150, 50):
        out, chunked = tdec.forward_with_cache(cfg, params,
                                               tokens[:, a:a + 50], chunked)
    assert float((out[0, -1] - ref[0, -1]).abs().max()) <= TOL_LOGITS_TWINS


def test_fused_cross_entropy_on_the_card_matches_its_cpu_result(card):
    """The vocab-tiled loss with bf16 hidden states and an f32 table on
    the card (``torch.mm(..., out_dtype=float32)`` tile products) against
    the same call on the CPU (operands widened to f32): the loss to 1e-5
    relative, dx (bf16) and demb (f32) within TOL_BF16, since ``dlog``
    rounds to bf16 from p computed in another summation order. A vocab of
    5000 in tiles of 1024 leaves a padded tail tile."""
    from kubeflow_tpu_torch.ops.cross_entropy import fused_ce

    x = _randn(card, 1000, 256)
    emb = torch.randn(5000, 256, device="cuda", generator=card) * 0.05
    targets = torch.randint(0, 5000, (1000,), device="cuda", generator=card)
    out = {}
    for dev in ("cuda", "cpu"):
        xd = x.detach().to(dev).requires_grad_(True)
        ed = emb.detach().to(dev).requires_grad_(True)
        loss = fused_ce(xd, ed, targets.to(dev), 1024).mean()
        gx, ge = torch.autograd.grad(loss, (xd, ed))
        out[dev] = (loss.detach().cpu(), gx.cpu(), ge.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    assert out["cuda"][1].dtype == torch.bfloat16
    assert out["cuda"][2].dtype == torch.float32
    _assert_close(out["cuda"][1], out["cpu"][1], TOL_BF16)
    _assert_close(out["cuda"][2], out["cpu"][2], TOL_BF16)


def test_flash_kernels_at_s8192_match_twins(card):
    """The long-context shape (B=1, 8 heads, S=8192, d=128, causal; 128
    query tiles a head): the forward with lse, dq and dk/dv against their
    twins."""
    from kubeflow_tpu_torch.ops.attention import (
        flash_dkv,
        flash_dkv_reference,
        flash_dq,
        flash_dq_reference,
        flash_forward,
        flash_forward_reference,
    )

    q, k, v, do = (_randn(card, 1, 8, 8192, 128) for _ in range(4))
    o, lse = flash_forward(q, k, v, causal=True)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_forward_reference(q, k, v, causal=True)
    _assert_close(o, o_ref, TOL_BF16)
    _assert_close(lse, lse_ref, TOL_F32)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta)
    dq = flash_dq(*args, causal=True)
    dk, dv = flash_dkv(*args, causal=True)
    torch.cuda.synchronize()
    _assert_close(dq, flash_dq_reference(*args, causal=True), TOL_BF16)
    dk_ref, dv_ref = flash_dkv_reference(*args, causal=True)
    _assert_close(dk, dk_ref, TOL_BF16)
    _assert_close(dv, dv_ref, TOL_BF16)


def test_resnet18_train_step_on_the_card_matches_the_cpu(card):
    """resnet18 (width 8, f32, 32x32) from one seeded state, every
    BatchNorm scale moved off its init: train-mode logits and one step
    (loss, params, batch_stats, SGD trace) on the card against the CPU,
    with TF32 off (cuDNN allows it for f32 convolutions by default): the
    same f32 arithmetic in another summation order, 1e-4 relative per
    leaf (in norm, a leaf floored at 2^-8 of its group's RMS, as the CPU
    tests hold the port to the JAX package)."""
    from kubeflow_tpu_torch.models import (
        create_train_state,
        make_train_step,
        resnet18,
    )
    from kubeflow_tpu_torch.models.checkpoint import (
        _arrays_only,
        _flatten_keys,
    )

    model = resnet18(num_classes=10, width=8, dtype=torch.float32)
    gen = torch.Generator().manual_seed(11)
    images = torch.randn((16, 32, 32, 3), generator=gen)
    labels = torch.randint(0, 10, (16,), generator=gen)
    states = {dev: create_train_state(model, seed=5,
                                      input_shape=(16, 32, 32, 3),
                                      device=dev) for dev in ("cpu", "cuda")}

    def leaves(state):
        return {k: v for k, v in _flatten_keys(_arrays_only(state))
                if isinstance(v, torch.Tensor)}

    card_leaves = leaves(states["cuda"])
    with torch.no_grad():
        for key, leaf in leaves(states["cpu"]).items():
            if key.endswith("['scale']"):
                leaf.add_(torch.randn(leaf.shape, generator=gen) * 0.2)
                card_leaves[key].copy_(leaf)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        logits = {dev: model(s.params, s.batch_stats, images.to(dev),
                             train=True)[0].detach().cpu()
                  for dev, s in states.items()}
        torch.testing.assert_close(
            logits["cuda"], logits["cpu"], rtol=0,
            atol=1e-4 * float(logits["cpu"].abs().max()))
        losses = {}
        for dev, s in states.items():
            _, metrics = make_train_step()(s, {"image": images.to(dev),
                                               "label": labels.to(dev)})
            losses[dev] = float(metrics["loss"])
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4
    got = {k: v.detach().cpu().double() for k, v in
           leaves(states["cuda"]).items()}
    want = {k: v.detach().double() for k, v in leaves(states["cpu"]).items()}
    for group in ("['params']", "['batch_stats']", "['opt_state']"):
        keys = [k for k in want if k.startswith(group)]
        rms = (sum(float(want[k].pow(2).sum()) for k in keys)
               / sum(want[k].numel() for k in keys)) ** 0.5
        for k in keys:
            floor = ROW_RMS_FLOOR * rms * want[k].numel() ** 0.5
            err = float((got[k] - want[k]).norm()) / max(
                float(want[k].norm()), floor)
            assert err <= 1e-4, (k, err)


# A bf16 path on the card against the f32 plain path on the same weights:
# the chip smoke's TOL_LOGITS.
TOL_LOGITS_F32 = 0.25


def _plain_f32_logits(cfg, params, tokens):
    """The f32 plain path's logits (1, S, vocab) for one token row."""
    import dataclasses

    from kubeflow_tpu_torch.models import build_lm
    from kubeflow_tpu_torch.models.optim import tree_map

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.no_grad():
        return build_lm(cfg32, use_flash=False)(
            tree_map(lambda t: t.float(), params),
            torch.tensor([tokens], device="cuda"))


def test_speculative_decoding_on_the_card(card):
    """speculative_generate and the spec engine on a tiny bf16 model: the
    prefill launches the flash kernel, and every emitted greedy token is
    within TOL_LOGITS_F32 of the f32 plain path's best at its position
    (the verify chunk's dense products and generate's single-token
    kernels round differently on the card, so equality with generate is
    not required here; the CPU tests pin it)."""
    from kubeflow_tpu_torch.models.speculative import speculative_generate
    from kubeflow_tpu_torch.models.transformer import LMConfig, init_params
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.serving import make_engine

    cfg = LMConfig(vocab=512, layers=2, dim=256, heads=4, kv_heads=2,
                   dtype=torch.bfloat16)
    params = init_params(cfg, seed=2, device="cuda", dtype=torch.bfloat16)
    prompts = [[(11 * i) % 97 for i in range(n)] * 3 for n in (20, 33)]
    _build.reset_launches()
    out, stats = speculative_generate(cfg, params, [prompts[0]], 24,
                                      return_stats=True)
    assert _build.LAUNCHES["flash_attention"] == cfg.layers
    assert stats.verify_calls >= 1
    engine = make_engine(cfg, params, max_batch=2, max_len=256,
                         spec_ngram=True, spec_draft=4)
    done = {}
    for i, p in enumerate(prompts):
        engine.submit_stream(p, lambda e, i=i: done.__setitem__(i, e)
                             if e.get("done") else None, max_new_tokens=16)
    engine.drain()
    assert engine.cycle_seconds["verify"].count >= 1
    streams = [(prompts[0], out[0].tolist())] + [
        (p, done[i]["tokens"]) for i, p in enumerate(prompts)]
    for prompt, toks in streams:
        logits = _plain_f32_logits(cfg, params, prompt + toks)[0]
        rows = logits[len(prompt) - 1:len(prompt) - 1 + len(toks)]
        picked = rows.gather(1, torch.tensor(toks, device="cuda")[:, None])
        gap = float((rows.max(-1).values - picked[:, 0]).max())
        assert gap <= TOL_LOGITS_F32, gap


def test_moe_decode_and_the_fallback_engine_on_the_card(card):
    """A tiny bf16 top-2 MoE model decodes on the card through every
    serving kernel (the dense blocks' GEMVs, the fused QKV+RoPE,
    flash-decode, the flash prefill); its first decode step's logits
    agree with the same call on CPU copies (every wrapper's twin) within
    TOL_LOGITS_TWINS; the fallback engine streams generate()'s tokens."""
    from kubeflow_tpu_torch.models import decoding as tdec
    from kubeflow_tpu_torch.models.optim import tree_map
    from kubeflow_tpu_torch.models.transformer import LMConfig, init_params
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.serving import GenerateFallbackEngine, make_engine

    cfg = LMConfig(vocab=512, layers=2, dim=256, heads=4, moe_experts=4,
                   moe_top_k=2, dtype=torch.bfloat16)
    params = init_params(cfg, seed=3, device="cuda", dtype=torch.bfloat16)
    cpu = tree_map(lambda t: t.cpu(), params)
    prompt = [[(5 * i + 1) % cfg.vocab for i in range(40)]]

    def first_decode_logits(p, device):
        cache = tdec.KVCache.init(cfg, 1, 48, device=device)
        logits, cache = tdec.forward_with_cache(cfg, p, prompt, cache,
                                                last_logits_only=True,
                                                device=device)
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        return tdec.forward_with_cache(cfg, p, nxt, cache, device=device)[0]

    _build.reset_launches()
    want = tdec.generate(cfg, params, prompt, 8)
    serving = ("flash_attention", "gemv", "qkv_rope", "decode_attention")
    assert all(_build.LAUNCHES[n] > 0 for n in serving), _build.LAUNCHES
    card_logits = first_decode_logits(params, "cuda").cpu()
    cpu_logits = first_decode_logits(cpu, "cpu")
    assert float((card_logits - cpu_logits).abs().max()) <= TOL_LOGITS_TWINS
    engine = make_engine(cfg, params, max_len=256)
    assert isinstance(engine, GenerateFallbackEngine)
    done = {}
    engine.submit_stream(prompt[0], lambda e: done.update(e)
                         if e.get("done") else None, max_new_tokens=8)
    engine.drain()
    assert done["tokens"] == want[0].tolist()


@pytest.fixture
def card_mesh(card):
    """A mesh at world 1 over the card: the NCCL world that ``make_mesh``
    forms itself, torn down after the test."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec())
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_lm_mesh_step_at_world_one_equals_the_meshless_step(card_mesh):
    """A 2-layer bf16 LM (head dim 128: the flash kernels) one step on
    the world-1 mesh and one without: the loss within 1e-5 relative (the
    mesh path sums NLL over the batch's count where the meshless one
    takes a mean), every leaf after the step within 1e-5 in relative
    norm, one launch of each flash kernel a layer on both."""
    from kubeflow_tpu_torch.models import (
        LMConfig,
        build_lm,
        create_lm_state,
        gather_state,
        make_lm_train_step,
    )
    from kubeflow_tpu_torch.models.optim import flatten
    from kubeflow_tpu_torch.ops import _build

    cfg = LMConfig(vocab=512, layers=2, dim=256, heads=2,
                   dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (2, 256), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(3))
    runs = {}
    for name, mesh in (("meshless", None), ("mesh", card_mesh)):
        state = create_lm_state(build_lm(cfg, mesh), seed=0, mesh=mesh)
        _build.reset_launches()
        state, metrics = make_lm_train_step(mesh, cfg=cfg)(
            state, {"tokens": tokens})
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        for kernel in ("flash_attention", "flash_dq", "flash_dkv"):
            assert launches[kernel] == cfg.layers, (name, launches)
        whole = gather_state(state) if mesh is not None else state
        runs[name] = (float(metrics["loss"]),
                      {k: v.detach() for k, v in flatten(whole.params)})
    loss, params = runs["mesh"]
    want_loss, want = runs["meshless"]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for path, p in params.items():
        err = float((p - want[path]).norm() / want[path].norm())
        assert err <= 1e-5, (path, err)


def test_batch_norm_group_path_at_world_one_equals_the_groupless_path(
        card_mesh):
    """With a group of one (an NCCL all-reduce over one rank) the moments
    and the backward's sums are the groupless ones bit for bit: outputs,
    running statistics and all three gradients."""
    from kubeflow_tpu_torch.models.resnet import batch_norm

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((8, 16, 12, 12), generator=gen,
                    device="cuda").bfloat16()
    p = {"scale": torch.randn(16, generator=gen, device="cuda"),
         "bias": torch.randn(16, generator=gen, device="cuda")}
    stats = {"mean": torch.zeros(16, device="cuda"),
             "var": torch.ones(16, device="cuda")}
    g = torch.randn(x.shape, generator=gen, device="cuda").bfloat16()
    out = {}
    for name, group in (("none", None),
                        ("group", card_mesh.group(("dp", "fsdp")))):
        inputs = [t.clone().requires_grad_() for t in (x, p["scale"],
                                                       p["bias"])]
        y, new = batch_norm({"scale": inputs[1], "bias": inputs[2]}, stats,
                            inputs[0], True, group)
        out[name] = [y, new["mean"], new["var"],
                     *torch.autograd.grad(y, inputs, g)]
    for a, b in zip(out["group"], out["none"]):
        assert torch.equal(a, b)


def test_loop_telemetry_times_every_step_without_a_sync_a_step(card,
                                                               monkeypatch):
    """``run_steps`` with step telemetry on the card: one record a step,
    each timed by an event pair, and a metric read (a host sync) on the
    first step only."""
    from kubeflow_tpu_torch.models.train import run_steps
    from kubeflow_tpu_torch.models.transformer import (
        LMConfig,
        build_lm,
        create_lm_state,
        make_lm_train_step,
    )
    from kubeflow_tpu_torch.obs.telemetry import StepTelemetry

    cfg = LMConfig(vocab=512, layers=2, dim=128, heads=2,
                   dtype=torch.bfloat16)
    state = create_lm_state(build_lm(cfg), seed=0, device="cuda")
    batches = [{"tokens": torch.randint(0, 512, (2, 256), device="cuda",
                                        generator=card)} for _ in range(6)]
    reads = []
    to_float = torch.Tensor.__float__
    monkeypatch.setattr(torch.Tensor, "__float__",
                        lambda t: reads.append(1) or to_float(t))
    meter = StepTelemetry(flops_per_example=1e6)
    run_steps(make_lm_train_step(cfg=cfg), state, batches, telemetry=meter)
    assert len(reads) == 1
    times = [r["step_time_s"] for r in meter.records]
    # The first step builds the kernels; the tiny steps after it take ms.
    assert len(times) == 6 and all(t > 0 for t in times)
    assert max(times[1:]) < 1.0


# A bf16 product on tensor cores against its widened twin (the same bf16
# operands multiplied in f32, rounded once): the f32 sums differ only in
# order, by ~2^-24 * sqrt(K / 2) of a row's RMS (~5e-6 at K = 16384), so
# each element rounds to the twin's bf16 value or a neighbour. Near zero
# that sum noise exceeds a bf16 ulp of the element itself, so an element
# is held at one ulp of the larger of its magnitude and ULP_FLOOR of its
# row's RMS (the row RMS floored as in ``_assert_close``). A reduction
# rounded to bf16 on the way (split-K partials in the output type) misses
# that by ~2^-9 of a partial, tens of ulps at the floor.
ULP_FLOOR = 2.0 ** -6
LM_CELL = {"tokens": 16384, "dim": 1024, "hidden": 4096, "vocab": 32768}


def _assert_within_one_ulp(out, twin):
    assert out.dtype == twin.dtype == torch.bfloat16, (out.dtype, twin.dtype)
    o, r = out.float(), twin.float()
    rms = torch.maximum(r.pow(2).mean(-1, keepdim=True).sqrt(),
                        ROW_RMS_FLOOR * r.pow(2).mean().sqrt())
    _, exp = torch.frexp(torch.maximum(r.abs(), ULP_FLOOR * rms))
    ulp = torch.ldexp(torch.ones_like(r), exp - 8)
    ulps = (o - r).abs() / ulp
    bad = ~(ulps <= 1)   # NaN fails too
    assert not bad.any(), (f"{int(bad.sum())} elements beyond one bf16 ulp; "
                           f"worst {float(ulps.max())} ulps")


@pytest.mark.parametrize("tokens", [LM_CELL["tokens"], 256, 32],
                         ids=["lm_cell", "small", "tiny"])
@pytest.mark.parametrize("fan_in,fan_out", [(1024, 1024), (1024, 4096),
                                            (4096, 1024)],
                         ids=["qkv_proj", "up", "down"])
def test_dense_on_tensor_cores_matches_the_widened_product(card, fan_in,
                                                           fan_out, tokens):
    """``_dense`` against the widened f32 expression it replaces on the
    card, at the LM cell's shapes (8 x 2048 tokens) and at small batches
    (down to 32 tokens over a 4096-term sum), where a library is likeliest
    to split a sum: the bf16 output, the bf16 input gradient and the
    weight gradient (rounded to bf16, then widened to the f32 kernel's
    dtype) each within one bf16 ulp. The output and the input gradient
    equal the f32-output product rounded once, bit for bit: no partial
    sum of theirs was rounded to bf16 on the way."""
    from kubeflow_tpu_torch.models.transformer import (
        TENSOR_CORE_PRODUCTS,
        _dense,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    h = _randn(card, 8, tokens // 8, fan_in).requires_grad_()
    w = (torch.randn(fan_in, fan_out, device="cuda", generator=card)
         * fan_in ** -0.5).requires_grad_()
    g = _randn(card, *h.shape[:-1], fan_out, std=1e-3)
    before = TENSOR_CORE_PRODUCTS["dense_mm"]
    out = _dense(h, w, bf16)
    assert TENSOR_CORE_PRODUCTS["dense_mm"] == before + 1
    twin = (h.float() @ w.to(bf16).float()).to(bf16)
    grads = torch.autograd.grad(out, (h, w), g)
    twin_grads = torch.autograd.grad(twin, (h, w), g)
    assert grads[1].dtype == twin_grads[1].dtype == torch.float32
    _assert_within_one_ulp(out, twin)
    _assert_within_one_ulp(grads[0], twin_grads[0])
    _assert_within_one_ulp(grads[1].to(bf16), twin_grads[1].to(bf16))
    assert torch.equal(grads[1], grads[1].to(bf16).float())
    h2, wb, g2 = h.detach().flatten(0, 1), w.detach().to(bf16), g.flatten(0, 1)
    assert torch.equal(out.flatten(0, 1),
                       torch.mm(h2, wb, out_dtype=f32).to(bf16))
    assert torch.equal(grads[0].flatten(0, 1),
                       torch.mm(g2, wb.t(), out_dtype=f32).to(bf16))


def test_tied_head_on_tensor_cores_matches_the_widened_product(card):
    """``tied_head`` at the LM cell's shape ((16384, 1024) against the
    (32768, 1024) embedding): f32 logits within TOL_F32; the backward's
    f32 sums over the exact three-way split of the f32 logit gradient, in
    chunks of ``HEAD_SUM_CHUNK`` terms, within TOL_F32 of the f32
    products (one tensor-core sum over all 3 x 32768 terms misses it:
    the card's accumulation truncates as it adds); dx (bf16) and the
    embedding's gradient (rounded to bf16, widened to f32) within one
    bf16 ulp of the widened expression's."""
    from kubeflow_tpu_torch.models.transformer import (
        TENSOR_CORE_PRODUCTS,
        _mm_f32_chunked,
        tied_head,
    )
    from kubeflow_tpu_torch.ops.split import split3

    bf16 = torch.bfloat16
    n, d, v = LM_CELL["tokens"], LM_CELL["dim"], LM_CELL["vocab"]
    x = _randn(card, 8, n // 8, d).requires_grad_()
    emb = (torch.randn(v, d, device="cuda", generator=card)
           * 0.02).requires_grad_()
    # A softmax-like logit gradient: ~1/(vocab x tokens) everywhere, one
    # large negative entry a row.
    g = torch.rand(n, v, device="cuda", generator=card) * 2.0 / (v * n)
    hot = torch.randint(0, v, (n,), device="cuda", generator=card)
    g[torch.arange(n, device="cuda"), hot] = -1.0 / n
    g = g.reshape(8, n // 8, v)
    before = TENSOR_CORE_PRODUCTS["head_mm"]
    out = tied_head(x, emb, bf16)
    assert TENSOR_CORE_PRODUCTS["head_mm"] == before + 1
    twin = torch.einsum("bsd,vd->bsv", x.float(), emb.to(bf16).float())
    assert out.dtype == torch.float32
    _assert_close(out, twin, TOL_F32)
    del twin
    grads = torch.autograd.grad(out, (x, emb), g)
    del out
    xw, ew = x.detach().reshape(n, d), emb.detach().to(bf16)
    gf = g.reshape(n, v)
    parts = split3(gf)
    _assert_close(_mm_f32_chunked(parts, ew.repeat(3, 1)), gf @ ew.float(),
                  TOL_F32)
    sums = _mm_f32_chunked(parts.t(), xw).view(3, v, d).sum(0)
    _assert_close(sums, gf.t() @ xw.float(), TOL_F32)
    del parts, sums
    xt = x.detach().float().requires_grad_()
    et = emb.detach().clone().requires_grad_()
    twin = torch.einsum("bsd,vd->bsv", xt, et.to(bf16).float())
    twin_grads = torch.autograd.grad(twin, (xt, et), g)
    assert grads[0].dtype == bf16 and grads[1].dtype == torch.float32
    _assert_within_one_ulp(grads[0], twin_grads[0].to(bf16))
    _assert_within_one_ulp(grads[1].to(bf16), twin_grads[1].to(bf16))
    assert torch.equal(grads[1], grads[1].to(bf16).float())


@pytest.mark.parametrize("shape", [(16384, 32768), (37, 1001), (3, 4)],
                         ids=["lm_cell", "ragged", "tiny"])
def test_split3_kernel_matches_its_twin_bit_for_bit(card, shape):
    """The one-pass split against its plain twin: the same bits, and the
    three terms sum back to the input exactly (f32 values of magnitude
    2^-100 to 2^100, both signs, zeros). A width that is no multiple of
    four takes the kernel's one-element path."""
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops.split import split3, split3_reference

    exp = torch.randint(-100, 101, shape, device="cuda", generator=card)
    mant = 1.0 + torch.rand(shape, device="cuda", generator=card)
    sign = torch.randint(0, 2, shape, device="cuda", generator=card) * 2 - 1
    g = (sign * mant * torch.pow(2.0, exp.float())).float()
    g.view(-1)[::7] = 0.0
    before = _build.LAUNCHES["split3"]
    parts = split3(g)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["split3"] == before + 1
    assert torch.equal(parts, split3_reference(g))
    cols = shape[1]
    total = sum(parts[:, i * cols:(i + 1) * cols].double() for i in range(3))
    assert torch.equal(total.float(), g)


def test_lm_cell_step_counts_its_tensor_core_products(card):
    """One train step of the LM cell's configuration (8 x 1024, vocab
    32768, 8 x 2048 tokens, the dense loss) runs six block products a
    layer and the tied head on tensor cores, and splits the head's
    gradient once."""
    from kubeflow_tpu_torch.models import (
        LMConfig,
        build_lm,
        create_lm_state,
        make_lm_train_step,
    )
    from kubeflow_tpu_torch.ops import _build

    cfg = LMConfig(vocab=32768, layers=8, dim=1024, heads=8,
                   dtype=torch.bfloat16)
    state = create_lm_state(build_lm(cfg), seed=0)
    tokens = torch.randint(0, cfg.vocab, (8, 2048), device="cuda",
                           generator=card)
    from kubeflow_tpu_torch.models.transformer import TENSOR_CORE_PRODUCTS

    before = {**TENSOR_CORE_PRODUCTS, "split3": _build.LAUNCHES["split3"]}
    _, metrics = make_lm_train_step(cfg=cfg)(state, {"tokens": tokens})
    assert float(metrics["loss"]) == float(metrics["loss"])
    after = {**TENSOR_CORE_PRODUCTS, "split3": _build.LAUNCHES["split3"]}
    moved = {k: after[k] - before[k] for k in before}
    assert moved == {"dense_mm": 6 * cfg.layers, "head_mm": 1, "split3": 1}


# ----------------------------------------------- BatchNorm with its ReLU

# (N, C, H, W): ResNet-50's stem norm and a stage-4 norm at batch 256 and
# 224x224, and a ragged one (C = 20: 16-byte loads for f32, 8-byte for
# bf16; 3 * 37 * 29 rows, no multiple of a block's rows).
BN_SHAPES = {"stem": (256, 64, 112, 112), "stage4": (256, 2048, 7, 7),
             "ragged": (3, 20, 37, 29)}
# Summation order only: the kernels sum each thread's rows in order, a
# block's rows in a tree and the row blocks in order; the twin is
# PyTorch's reduction. A channel's mean is held to BN_SUM_RTOL of its RMS
# and its mean square to BN_SUM_RTOL of itself; a backward sum to
# BN_SUM_RTOL of the sum of its terms' magnitudes (above the worst case
# of ~140 f32 roundings deep that the kernels' order allows: 8.4e-6).
BN_SUM_RTOL = 1e-5


def _bn_inputs(gen, shape, dtype, epilogue, constant=False):
    """x, scale, bias, running mean and var, residual and an output
    gradient, channels-last; with ``constant`` channel 0 of x is one
    value (its variance is 0 or clips to 0)."""
    n, c, h, w = shape

    def act(std=1.0, shift=0.0):
        t = torch.randn((n, h, w, c), generator=gen, device="cuda")
        return (t * std + shift).to(dtype).permute(0, 3, 1, 2)

    x = act(2.0, 0.5)
    if constant:
        x[:, 0] = 1.5
    vec = [torch.randn(c, generator=gen, device="cuda") for _ in range(3)]
    run_var = torch.rand(c, generator=gen, device="cuda") + 0.5
    residual = act() if epilogue == "residual" else None
    return x, vec[0], vec[1], vec[2], run_var, residual, act()


@pytest.mark.parametrize("epilogue", ["none", "relu", "residual"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", sorted(BN_SHAPES))
def test_batch_norm_kernels_match_their_twins(card, shape, dtype, epilogue):
    """Each pass against the twin on the card: the statistics within the
    summation-order tolerance, the apply bit for bit given the kernel's
    statistics (mean, var, rstd, the running averages, the output), the
    backward's sums within the tolerance and dx and the residual's
    gradient bit for bit given the kernel's sums; two launches of each
    pass give the same bits. The ragged shape holds a constant channel,
    whose variance is 0 or clips to 0."""
    from kubeflow_tpu_torch.ops import batch_norm as bn

    x, scale, bias, run_mean, run_var, residual, g = _bn_inputs(
        card, BN_SHAPES[shape], dtype, epilogue, constant=shape == "ragged")
    relu = epilogue != "none"
    moments = bn.stats(x)
    want = bn.moments_reference(x)
    rms = want[1].sqrt()
    assert ((moments[0] - want[0]).abs() <= BN_SUM_RTOL * rms).all()
    assert ((moments[1] - want[1]).abs() <= BN_SUM_RTOL * want[1]).all()

    out, saved, new_mean, new_var = bn.apply(x, moments, scale, bias,
                                             run_mean, run_var, residual,
                                             relu)
    mean, var, rstd = saved
    assert torch.equal(mean, moments[0])
    assert torch.equal(var, torch.clamp_min(moments[1] - mean * mean, 0.0))
    # 1 / sqrt(var + eps), each step rounded once in f32 (PyTorch's rsqrt
    # on the card is rsqrtf, within 2 ulps).
    assert torch.equal(rstd, 1.0 / torch.sqrt(var + bn.EPSILON))
    assert torch.equal(new_mean, bn.MOMENTUM * run_mean
                       + (1 - bn.MOMENTUM) * mean)
    assert torch.equal(new_var, bn.MOMENTUM * run_var
                       + (1 - bn.MOMENTUM) * var)
    assert torch.equal(out, bn.normalize_reference(x, mean, rstd * scale,
                                                   bias, residual, relu))

    masked = bn.masked_grad(g, out) if relu else g
    dbias, dscale = bn.grad_sums(g, x, out if relu else None, saved)
    want_b, want_s = bn.grad_sums_reference(masked, x, mean, rstd)
    xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
    mag_b = masked.float().abs().sum(dim=(0, 2, 3))
    mag_s = (masked.float() * xhat).abs().sum(dim=(0, 2, 3))
    assert ((dbias - want_b).abs() <= BN_SUM_RTOL * mag_b).all()
    assert ((dscale - want_s).abs() <= BN_SUM_RTOL * mag_s).all()

    count = x.numel() // x.shape[1]
    dx, dres = bn.dx(g, x, out if relu else None, saved, scale, dbias,
                     dscale, count, epilogue == "residual")
    assert torch.equal(dx, bn.dx_reference(masked, x, mean, var, rstd,
                                           scale, dbias, dscale, count))
    if epilogue == "residual":
        assert torch.equal(dres, masked)
    again = (bn.stats(x),
             bn.apply(x, moments, scale, bias, run_mean, run_var, residual,
                      relu)[0],
             *bn.grad_sums(g, x, out if relu else None, saved),
             bn.dx(g, x, out if relu else None, saved, scale, dbias, dscale,
                   count, epilogue == "residual")[0])
    for a, b in zip(again, (moments, out, dbias, dscale, dx)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("epilogue", ["none", "relu", "residual"])
def test_batch_norm_train_on_the_card_matches_the_twin_end_to_end(
        card, epilogue):
    """``batch_norm_train`` through autograd on the card (the kernels)
    against the same call on the CPU (the twins) at the ragged shape in
    f32: the output, the running averages and every gradient within the
    f32 summation-order tolerance; one launch of each kernel."""
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops.batch_norm import batch_norm_train

    x, scale, bias, run_mean, run_var, residual, g = _bn_inputs(
        card, BN_SHAPES["ragged"], torch.float32, epilogue)
    runs = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_()
                  for t in (x, scale, bias, residual) if t is not None]
        res = leaves[3] if residual is not None else None
        _build.reset_launches()
        out, new_mean, new_var = batch_norm_train(
            leaves[0], leaves[1], leaves[2], run_mean.to(dev),
            run_var.to(dev), relu=epilogue != "none", residual=res)
        grads = torch.autograd.grad(out, leaves, g.to(dev))
        runs[dev] = [t.detach().cpu() for t in (out, new_mean, new_var,
                                                *grads)]
        if dev == "cuda":
            launches = {k: v for k, v in _build.LAUNCHES.items()
                        if k.startswith("bn_")}
            assert launches == {"bn_stats": 1, "bn_apply": 1,
                                "bn_grad_sums": 1, "bn_dx": 1}
    for got, want in zip(runs["cuda"], runs["cpu"]):
        _assert_close(got.reshape(-1, got.shape[-1]),
                      want.reshape(-1, want.shape[-1]), TOL_F32)


@pytest.mark.parametrize("epilogue", ["none", "relu", "residual"])
def test_batch_norm_train_with_a_group_of_one_equals_the_groupless_call(
        card_mesh, epilogue):
    """``batch_norm_train`` on the card with the world-1 mesh's (dp, fsdp)
    group (the moments taken over 1 / (rows * 1), the NCCL all-reduces
    of the moments and the backward's sums between the passes) against
    the call without a group, in bf16 at the ragged shape: the output,
    the running averages and every gradient bit for bit."""
    from kubeflow_tpu_torch.ops.batch_norm import batch_norm_train

    x, scale, bias, run_mean, run_var, residual, g = _bn_inputs(
        torch.Generator(device="cuda").manual_seed(6), BN_SHAPES["ragged"],
        torch.bfloat16, epilogue)
    runs = {}
    for name, group in (("none", None),
                        ("group", card_mesh.group(("dp", "fsdp")))):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, scale, bias, residual) if t is not None]
        res = leaves[3] if residual is not None else None
        out, new_mean, new_var = batch_norm_train(
            leaves[0], leaves[1], leaves[2], run_mean, run_var, group,
            relu=epilogue != "none", residual=res)
        runs[name] = [out, new_mean, new_var,
                      *torch.autograd.grad(out, leaves, g)]
    for a, b in zip(runs["group"], runs["none"]):
        assert torch.equal(a, b)


def test_batch_norm_kernels_raise_on_what_they_do_not_take(card):
    """An f16 activation, f64 statistics: the wrapper raises on the card
    (no fallback to the twin)."""
    from kubeflow_tpu_torch.ops.batch_norm import batch_norm_train

    x, scale, bias, run_mean, run_var, _, _ = _bn_inputs(
        card, BN_SHAPES["ragged"], torch.float32, "none")
    with pytest.raises(ValueError):
        batch_norm_train(x.half(), scale, bias, run_mean, run_var)
    with pytest.raises(ValueError):
        batch_norm_train(x, scale, bias, run_mean.double(), run_var)


def test_resnet50_step_launches_each_batch_norm_kernel_once_a_norm(card):
    """One ResNet-50 train step (64x64 images, batch 8) runs each of the
    four BatchNorm kernels once for each of its 53 norms."""
    from kubeflow_tpu_torch.models import (
        create_train_state,
        make_train_step,
        resnet50,
    )
    from kubeflow_tpu_torch.ops import _build

    model = resnet50(num_classes=10)
    state = create_train_state(model, seed=0, input_shape=(8, 64, 64, 3))
    batch = {"image": torch.randn((8, 64, 64, 3), generator=card,
                                  device="cuda").bfloat16(),
             "label": torch.randint(0, 10, (8,), generator=card,
                                    device="cuda")}
    _build.reset_launches()
    _, metrics = make_train_step()(state, batch)
    assert float(metrics["loss"]) == float(metrics["loss"])
    assert {k: v for k, v in _build.LAUNCHES.items() if k.startswith("bn_")
            } == {"bn_stats": 53, "bn_apply": 53, "bn_grad_sums": 53,
                  "bn_dx": 53}

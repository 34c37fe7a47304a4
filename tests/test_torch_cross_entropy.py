"""CPU parity of the port's fused cross-entropy
(``kubeflow_tpu_torch/ops/cross_entropy.py``) and of the LM train step
that takes it, against the JAX package.

Inputs come from seeded numpy generators and go through both sides; the
JAX side runs on the CPU (its fused loss is plain XLA, no Pallas
kernel), its attention kernels in interpret mode. The cases follow
``tests/test_ops.py::TestFusedCE``: blocks 16, 64 and 7 (7 leaves a
padded tail tile over a vocab of 50), and the packed loss. Tolerances,
each with its reason:

- f32, loss against the JAX ``fused_ce``/``fused_lm_loss`` and its
  ``jax.grad``: 1e-5 relative for the loss, 1e-4 relative (1e-5
  absolute) for the gradients: the same arithmetic summed in another
  order (measured: ~1e-7).
- bf16 operands (compute dtype bf16, f32 accumulation on both sides):
  the logits, p and ``dlog`` round at the same points, so the loss and
  the gradients hold to the f32 limits above (measured: equal bits for
  5 seeds and both blocks but one element, 1.4e-9 of the largest).
- the port's fused step against its own dense step: one step, the loss
  within 1e-5 and the parameters within 1e-4 relative (1e-5 absolute),
  as the reference holds its own pair.
- 3 steps of ``loss_impl="fused"`` from a carried state against the
  JAX step: as ``tests/test_torch_train.py`` holds the dense loss.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import LMConfig as JConfig
from kubeflow_tpu.models import build_lm as jbuild_lm
from kubeflow_tpu.models import create_lm_state as jcreate_lm_state
from kubeflow_tpu.models.transformer import make_lm_train_step as jmake_step
from kubeflow_tpu.ops import cross_entropy as jce
from kubeflow_tpu_torch.models import (
    LMConfig,
    build_lm,
    create_lm_state,
    lm_loss,
    make_lm_train_step,
    train_state_from_jax,
)
from kubeflow_tpu_torch.models import transformer
from kubeflow_tpu_torch.models.optim import flatten
from kubeflow_tpu_torch.ops import cross_entropy as ce
from kubeflow_tpu_torch.ops.cross_entropy import fused_ce, fused_lm_loss

SMALL = dict(vocab=128, layers=2, dim=64, heads=4, kv_heads=2)


def _data(n=12, d=16, v=50, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(v, d)).astype(np.float32),
            rng.integers(0, v, n).astype(np.int32))


def _port_loss_and_grads(fn, x, emb, *args, dtype=torch.float32, **kw):
    xt = torch.from_numpy(np.array(x)).to(dtype).requires_grad_(True)
    et = torch.from_numpy(np.array(emb)).requires_grad_(True)
    loss = fn(xt, et, *args, **kw)
    gx, ge = torch.autograd.grad(loss, (xt, et))
    return float(loss.detach()), gx.float().numpy(), ge.numpy()


@pytest.mark.parametrize("block", [16, 64, 7])
def test_nll_and_grads_match_jax_fused_ce(block):
    x, emb, t = _data()
    jloss, (jgx, jge) = jax.value_and_grad(
        lambda x, e: jce.fused_ce(x, e, jnp.asarray(t), block).mean(),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(emb))
    loss, gx, ge = _port_loss_and_grads(
        lambda x, e: fused_ce(x, e, torch.from_numpy(t), block).mean(), x, emb)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    np.testing.assert_allclose(gx, np.asarray(jgx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ge, np.asarray(jge), rtol=1e-4, atol=1e-5)
    # And the per-position NLL against the dense logits.
    nll = fused_ce(torch.from_numpy(x), torch.from_numpy(emb),
                   torch.from_numpy(t), block)
    dense = torch.nn.functional.cross_entropy(
        torch.from_numpy(x) @ torch.from_numpy(emb).t(),
        torch.from_numpy(t).long(), reduction="none")
    np.testing.assert_allclose(nll.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("block", [16, 7])
def test_bf16_operands_match_jax(block):
    """x in bf16 (the model's activations), the f32 table cast to bf16
    tile by tile, f32 accumulation on both sides; dx comes back in bf16
    and demb in f32, as in the reference."""
    x, emb, t = _data(n=24, d=32, v=50, seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    jloss, (jgx, jge) = jax.value_and_grad(
        lambda x, e: jce.fused_ce(x, e, jnp.asarray(t), block).mean(),
        argnums=(0, 1))(xb, jnp.asarray(emb))
    # The port's x from the same bf16 values.
    x_bf16 = np.asarray(xb.astype(jnp.float32))
    loss, gx, ge = _port_loss_and_grads(
        lambda x, e: fused_ce(x, e, torch.from_numpy(t), block).mean(),
        x_bf16, emb, dtype=torch.bfloat16)
    assert jgx.dtype == jnp.bfloat16 and jge.dtype == jnp.float32
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    np.testing.assert_allclose(gx, np.asarray(jgx.astype(jnp.float32)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ge, np.asarray(jge), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("segmented", [False, True],
                         ids=["plain", "packed"])
def test_packed_loss_and_grads_match_jax_fused_lm_loss(segmented):
    rng = np.random.default_rng(1)
    b, s, d, v = 2, 9, 16, 50
    hid = rng.normal(size=(b, s, d)).astype(np.float32)
    emb = rng.normal(size=(v, d)).astype(np.float32)
    toks = rng.integers(0, v, (b, s)).astype(np.int32)
    seg = (np.array([[0, 0, 0, 1, 1, 1, 2, 2, 2],
                     [0, 0, 0, 0, 1, 1, 1, 1, 1]], np.int32)
           if segmented else None)
    jseg = None if seg is None else jnp.asarray(seg)
    jloss, (jgh, jge) = jax.value_and_grad(
        lambda h, e: jce.fused_lm_loss(h, e, jnp.asarray(toks), jseg,
                                       block=16),
        argnums=(0, 1))(jnp.asarray(hid), jnp.asarray(emb))
    tseg = None if seg is None else torch.from_numpy(seg)
    loss, gh, ge = _port_loss_and_grads(
        lambda h, e: fused_lm_loss(h, e, torch.from_numpy(toks), tseg,
                                   block=16), hid, emb)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    np.testing.assert_allclose(gh, np.asarray(jgh), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ge, np.asarray(jge), rtol=1e-4, atol=1e-5)
    # The same value as the port's dense loss on the full logits.
    logits = torch.einsum("bsd,vd->bsv", torch.from_numpy(hid),
                          torch.from_numpy(emb))
    np.testing.assert_allclose(
        loss, float(lm_loss(logits, torch.from_numpy(toks), tseg)),
        rtol=1e-5)


def test_forward_keeps_no_tile_for_autograd():
    """Only (x, emb, targets, lse) are saved: nothing of (N, block) or
    (N, vocab) size, which is the memory the op exists to avoid."""
    x, emb, t = _data(n=40, d=8, v=300, seed=2)
    xt = torch.from_numpy(x).requires_grad_(True)
    et = torch.from_numpy(emb).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda tensor: saved.append(tuple(tensor.shape)) or tensor,
            lambda tensor: tensor):
        nll = fused_ce(xt, et, torch.from_numpy(t), 64)
    assert sorted(saved) == sorted([(40, 8), (300, 8), (40,), (40,)])
    assert nll.shape == (40,) and nll.dtype == torch.float32


def test_block_must_be_positive():
    x, emb, t = _data()
    with pytest.raises(ValueError, match="block"):
        fused_ce(torch.from_numpy(x), torch.from_numpy(emb),
                 torch.from_numpy(t), 0)


# ----------------------------------------------------------- train step


def test_fused_step_tracks_the_dense_step():
    """The reference's ``test_train_step_fused_vs_dense_parity`` on the
    port: one step each from the same state and batch."""
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, 64, size=(2, 16))).long()
    states = {}
    for impl in ("fused", "dense"):
        cfg = LMConfig(vocab=64, layers=2, dim=32, heads=4, loss_impl=impl,
                       ce_block=16)
        state = create_lm_state(build_lm(cfg, use_flash=False), seed=0,
                                device="cpu")
        state, metrics = make_lm_train_step(cfg=cfg)(state,
                                                     {"tokens": tokens})
        states[impl] = (state, float(metrics["loss"]))
    assert abs(states["fused"][1] - states["dense"][1]) < 1e-5
    for (path, a), (_, b) in zip(flatten(states["fused"][0].params),
                                 flatten(states["dense"][0].params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=path)


def _batch(rng, b, s, vocab, segmented):
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    seg = None
    if segmented:  # packed documents of 10 to 40 tokens
        seg = np.zeros((b, s), np.int32)
        for row in seg:
            cuts = np.cumsum(rng.integers(10, 40, s))
            row[:] = np.searchsorted(cuts, np.arange(s), side="right")
    return tokens, seg


@pytest.mark.parametrize("dtype,segmented,block", [
    ("float32", False, 48), ("bfloat16", False, 48), ("float32", True, 128)],
    ids=["f32_padded_tail", "bf16_padded_tail", "f32_segments"])
def test_fused_train_step_matches_jax_from_a_carried_state(dtype, segmented,
                                                           block):
    """3 steps of ``loss_impl="fused"`` on both sides from one carried
    state (a vocab of 128 in tiles of 48 leaves a padded tail tile),
    as ``test_train_step_matches_jax_from_a_carried_state`` holds the
    dense loss: losses to 1e-5 (f32) / 1e-2 (bf16), each leaf's total
    update to 5e-3 / 0.25 of the reference's in relative norm."""
    jcfg = JConfig(dtype=jnp.dtype(dtype), loss_impl="fused", ce_block=block,
                   **SMALL)
    tcfg = LMConfig(dtype=getattr(torch, dtype), loss_impl="fused",
                    ce_block=block, **SMALL)
    jstate = jcreate_lm_state(jbuild_lm(jcfg, use_flash=True),
                              jax.random.key(0), (2, 64))
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate),
                                  apply_fn=build_lm(tcfg, use_flash=True),
                                  device="cpu")
    init = {path: p.detach().clone() for path, p in flatten(tstate.params)}
    jstep, tstep = jmake_step(cfg=jcfg), make_lm_train_step(cfg=tcfg)
    rng = np.random.default_rng(5)
    jl, tl = [], []
    for _ in range(3):
        tokens, seg = _batch(rng, 2, 64, SMALL["vocab"], segmented)
        jb = {"tokens": jnp.asarray(tokens)}
        tb = {"tokens": torch.from_numpy(tokens).long()}
        if seg is not None:
            jb["segment_ids"] = jnp.asarray(seg)
            tb["segment_ids"] = torch.from_numpy(seg)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    f32 = dtype == "float32"
    np.testing.assert_allclose(tl, jl, atol=1e-5 if f32 else 1e-2, rtol=0)
    assert tstate.step == int(jstate.step) == 3
    jparams = jax.tree.map(np.asarray, jstate.params)
    for path, p in flatten(tstate.params):
        want = jparams
        for key in path.split("/"):
            want = want[key]
        ref_update = torch.from_numpy(np.array(want)) - init[path]
        err = (p.detach() - init[path] - ref_update).norm() / ref_update.norm()
        assert err <= (5e-3 if f32 else 0.25), (path, float(err))


def test_auto_takes_the_fused_loss_from_the_reference_crossover(monkeypatch):
    """``"auto"`` dispatches on the sequence length at the reference's
    crossover (8192): at and above it the step computes
    ``fused_lm_loss`` on the hidden states with ``cfg.ce_block``; below
    it, ``lm_loss`` on the logits. The crossover is lowered here so the
    CPU run stays small."""
    assert transformer.AUTO_FUSED_MIN_SEQ == 8192
    calls = []

    def spy(hidden, embedding, *args, block=4096, **kwargs):
        calls.append((tuple(hidden.shape), hidden.dtype, block))
        return ce.fused_lm_loss(hidden, embedding, *args, block=block,
                                **kwargs)

    monkeypatch.setattr(transformer, "AUTO_FUSED_MIN_SEQ", 32)
    monkeypatch.setattr(transformer, "fused_lm_loss", spy)
    cfg = LMConfig(dtype=torch.float32, ce_block=40, **SMALL)
    state = create_lm_state(build_lm(cfg), seed=0, device="cpu")
    step = make_lm_train_step(cfg=cfg)
    step(state, {"tokens": torch.zeros(1, 31, dtype=torch.long)})
    assert calls == []
    step(state, {"tokens": torch.ones(1, 32, dtype=torch.long)})
    assert calls == [((1, 32, SMALL["dim"]), torch.float32, 40)]
    dense = make_lm_train_step(cfg=dataclasses.replace(cfg,
                                                       loss_impl="dense"))
    dense(state, {"tokens": torch.ones(1, 64, dtype=torch.long)})
    assert len(calls) == 1 and state.step == 3


def test_tile_products_widen_off_the_card():
    """Off the card a tile product widens its operands to f32 (exact for
    bf16 values) and accumulates in f32: bf16 operands give the f32
    product of their values."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.normal(size=(5, 32)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(32, 7)).astype(np.float32))
    out = ce._mm_f32(a.bfloat16(), b.bfloat16())
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, a.bfloat16().float()
                               @ b.bfloat16().float(), rtol=0, atol=0)

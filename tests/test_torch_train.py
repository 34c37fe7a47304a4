"""CPU parity of the port's training path against the JAX package.

Inputs come from seeded numpy generators and go through both sides; the
JAX flash kernels run in Pallas interpret mode (the default off-TPU), the
port's wrappers run their plain twins on CPU tensors. Tolerances, each
with its reason:

- ``TOL32`` (atol = rtol = 2e-5): f32 on both sides, the same arithmetic
  summed in a different order; attention gradients of order one.
- bf16 attention (``TOL_BF16_ATTN``, 2e-2 absolute): both sides round p
  and ds to bf16, the reference relative to each block's running max,
  the twin relative to the row's final max, so single elements differ by
  a bf16 ulp of values of order one.
- The train step, after 3 steps from one carried state: losses to 1e-5
  in f32 and 1e-2 in bf16, and each parameter leaf's total update (its
  change from the carried state) to within 5e-3 (f32) or 0.25 (bf16) of
  the reference's, in relative norm. The step-0 gradients agree to about
  1e-6 (f32) and 1.5% (bf16) of each leaf's largest element; Adam then
  divides each element by its own magnitude, which turns a tiny absolute
  difference in a near-zero gradient into a large one in its update
  (measured: 1.1e-3 in f32 and 0.126 in bf16 at worst). The optimizer
  itself is held tightly to optax on its own above.
"""

from __future__ import annotations

import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import LMConfig as JConfig
from kubeflow_tpu.models import build_lm as jbuild_lm
from kubeflow_tpu.models import create_lm_state as jcreate_lm_state
from kubeflow_tpu.models.transformer import lm_loss as jlm_loss
from kubeflow_tpu.models.transformer import make_lm_train_step as jmake_step
from kubeflow_tpu.ops import attention as jattn
from kubeflow_tpu_torch.models import (
    AdamW,
    LMConfig,
    build_lm,
    create_lm_state,
    lm_loss,
    make_lm_train_step,
    run_steps,
    train_state_from_jax,
)
from kubeflow_tpu_torch.models.optim import flatten
from kubeflow_tpu_torch.obs.telemetry import StepTelemetry
from kubeflow_tpu_torch.models.transformer import lm_placements
from kubeflow_tpu_torch.ops.attention import (
    flash_attention,
    flash_dkv,
    flash_dkv_reference,
    flash_dq,
    flash_dq_reference,
    flash_forward,
    flash_forward_reference,
    mha_reference,
)
from kubeflow_tpu_torch.serving import make_engine

TOL32 = dict(atol=2e-5, rtol=2e-5)
TOL_BF16_ATTN = dict(atol=2e-2, rtol=0)
SMALL = dict(vocab=128, layers=2, dim=64, heads=4, kv_heads=2)


def _np(t):
    return t.detach().float().numpy()


def _close(port, ref, **tol):
    np.testing.assert_allclose(_np(port), np.asarray(ref, np.float32), **tol)


# ------------------------------------------------------------ attention

# (name, causal, window, segmented, heads, kv_heads)
CASES = [
    ("causal", True, None, False, 4, 4),
    ("window", True, 24, False, 4, 4),
    ("non_causal", False, None, False, 4, 4),
    ("segments", True, None, True, 4, 4),
    ("gqa", True, None, False, 4, 2),
]


def _attn_inputs(case, seed=0, b=2, s=64, d=32):
    _, causal, window, segmented, h, hkv = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    seg = (np.sort(rng.integers(0, 3, (b, s)), axis=1).astype(np.int32)
           if segmented else None)
    return q, k, v, do, seg, dict(causal=causal, window=window)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_forward_twin_matches_jax_with_lse(case):
    q, k, v, _, seg, mask = _attn_inputs(case)
    scale = q.shape[-1] ** -0.5
    o_ref, lse_ref = jattn._flash_forward(
        _j(q), _j(k), _j(v), _j(seg), mask["causal"], mask["window"], scale,
        32, 32, True, with_lse=True)
    o, lse = flash_forward_reference(_t(q), _t(k), _t(v), segment_ids=_t(seg),
                                     **mask)
    _close(o, o_ref, **TOL32)
    b, h, s, _ = q.shape
    _close(lse, np.asarray(lse_ref)[:, 0, :].reshape(b, h, s), **TOL32)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_backward_twins_match_jax_kernels_and_grad(case):
    q, k, v, do, seg, mask = _attn_inputs(case, seed=1)
    scale = q.shape[-1] ** -0.5
    # The twins, end to end from the port's own forward.
    tq, tk, tv, tdo, tseg = map(_t, (q, k, v, do, seg))
    o, lse = flash_forward_reference(tq, tk, tv, segment_ids=tseg, **mask)
    delta = (tdo * o).sum(-1)
    kw = dict(segment_ids=tseg, **mask)
    dq = flash_dq_reference(tq, tk, tv, tdo, lse, delta, **kw)
    dk, dv = flash_dkv_reference(tq, tk, tv, tdo, lse, delta, **kw)
    assert dk.shape == tk.shape and dv.shape == tv.shape
    # The reference's two Pallas backward kernels (interpret mode).
    jo, jlse = jattn._flash_forward(
        _j(q), _j(k), _j(v), _j(seg), mask["causal"], mask["window"], scale,
        32, 32, True, with_lse=True)
    ref = jattn._flash_backward(_j(q), _j(k), _j(v), _j(seg), jo, jlse,
                                _j(do), mask["causal"], mask["window"],
                                scale, 32, 32, True)
    for port, want in zip((dq, dk, dv), ref):
        _close(port, want, **TOL32)
    # And jax.grad of the plain attention.
    _, vjp = jax.vjp(lambda a, b_, c: jattn.mha_reference(
        a, b_, c, segment_ids=_j(seg), **mask), _j(q), _j(k), _j(v))
    for port, want in zip((dq, dk, dv), vjp(_j(do))):
        _close(port, want, **TOL32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[4]],
                         ids=lambda c: c[0])
def test_flash_attention_autograd_matches_jax(case, dtype):
    q, k, v, do, seg, mask = _attn_inputs(case, seed=2)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx = [jnp.asarray(a).astype(jdt) for a in (q, k, v, do)]
    out_ref, vjp = jax.vjp(lambda a, b_, c: jattn.flash_attention(
        a, b_, c, segment_ids=_j(seg), block_q=32, block_k=32, **mask),
        *jx[:3])
    grads_ref = vjp(jx[3])
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
          for a in jx]
    leaves = [t.requires_grad_(True) for t in tx[:3]]
    out = flash_attention(*leaves, segment_ids=_t(seg), **mask)
    grads = torch.autograd.grad(out, leaves, tx[3])
    tol = TOL32 if dtype == "float32" else TOL_BF16_ATTN
    _close(out, np.asarray(out_ref.astype(jnp.float32)), **tol)
    for port, want in zip(grads, grads_ref):
        assert port.dtype == tdt
        _close(port, np.asarray(want.astype(jnp.float32)), **tol)


# ----------------------------------------------------------------- loss


@pytest.mark.parametrize("segmented", [False, True])
def test_lm_loss_matches_jax(segmented):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 16, 128)).astype(np.float32) * 3
    tokens = rng.integers(0, 128, (2, 16)).astype(np.int32)
    seg = (np.sort(rng.integers(0, 4, (2, 16)), axis=1).astype(np.int32)
           if segmented else None)
    ref = jlm_loss(jnp.asarray(logits), jnp.asarray(tokens), _j(seg))
    out = lm_loss(torch.from_numpy(logits), torch.from_numpy(tokens),
                  _t(seg))
    assert out.ndim == 0
    _close(out, ref, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------ optimizer


def test_adamw_matches_optax_with_bf16_first_moment():
    rng = np.random.default_rng(4)
    shapes = {"a": {"kernel": (8, 6)}, "b": {"scale": (6,)},
              "embed": {"embedding": (5, 6)}}
    params = {g: {n: rng.standard_normal(s).astype(np.float32)
                  for n, s in sub.items()} for g, sub in shapes.items()}
    tx = optax.adamw(3e-4, weight_decay=0.01, mu_dtype=jnp.bfloat16)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    port = AdamW(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
    tparams = {g: {n: torch.from_numpy(a.copy()) for n, a in sub.items()}
               for g, sub in params.items()}
    tstate = port.init(tparams)
    for step in range(3):
        grads = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32)
            * 10.0 ** -step, params)
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = {g: {n: torch.from_numpy(a) for n, a in sub.items()}
                  for g, sub in grads.items()}
        with torch.no_grad():
            port.update([t for _, t in flatten(tgrads)], tstate, tparams)
    adam = jstate[0]
    assert tstate.count == int(adam.count) == 3
    for (path, p), (_, mu), (_, nu) in zip(flatten(tparams),
                                           flatten(tstate.mu),
                                           flatten(tstate.nu)):
        g, n = path.split("/")
        assert mu.dtype == torch.bfloat16 and nu.dtype == torch.float32
        # mu is stored in bf16: equal bits, or one bf16 ulp where the f32
        # values straddle a rounding boundary.
        _close(mu, np.asarray(adam.mu[g][n].astype(jnp.float32)),
               atol=1e-6, rtol=2.0 ** -8)
        _close(nu, adam.nu[g][n], atol=0, rtol=1e-6)
        _close(p, jparams[g][n], atol=1e-7, rtol=1e-6)


# ----------------------------------------------------------- train step


def _batch(rng, b, s, vocab, segmented):
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    seg = None
    if segmented:  # packed documents of 10 to 40 tokens
        seg = np.zeros((b, s), np.int32)
        for row in seg:
            cuts = np.cumsum(rng.integers(10, 40, s))
            row[:] = np.searchsorted(cuts, np.arange(s), side="right")
    return tokens, seg


@pytest.mark.parametrize("dtype,segmented", [
    ("float32", False), ("bfloat16", False), ("float32", True)],
    ids=["f32", "bf16", "f32_segments"])
def test_train_step_matches_jax_from_a_carried_state(dtype, segmented):
    jcfg = JConfig(dtype=jnp.dtype(dtype), **SMALL)
    tcfg = LMConfig(dtype=getattr(torch, dtype), **SMALL)
    jmodel = jbuild_lm(jcfg, use_flash=True)
    jstate = jcreate_lm_state(jmodel, jax.random.key(0), (2, 64))
    # Carried across before the reference's step donates it.
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate),
                                  apply_fn=build_lm(tcfg, use_flash=True),
                                  device="cpu")
    assert tstate.step == 0 and tstate.opt_state.count == 0
    init = {path: p.detach().clone() for path, p in flatten(tstate.params)}
    jstep, tstep = jmake_step(cfg=jcfg), make_lm_train_step(cfg=tcfg)
    rng = np.random.default_rng(5)
    jl, tl = [], []
    for _ in range(3):
        tokens, seg = _batch(rng, 2, 64, SMALL["vocab"], segmented)
        jb = {"tokens": jnp.asarray(tokens)}
        tb = {"tokens": torch.from_numpy(tokens).long()}
        if seg is not None:
            jb["segment_ids"], tb["segment_ids"] = _j(seg), _t(seg)
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


def test_port_loss_falls_and_a_trained_state_serves_without_a_graph():
    cfg = LMConfig(dtype=torch.float32, **SMALL)
    state = create_lm_state(build_lm(cfg, use_flash=True), seed=1,
                            device="cpu")
    assert all(p.requires_grad and p.dtype == torch.float32
               for _, p in flatten(state.params))
    assert all(mu.dtype == torch.bfloat16
               for _, mu in flatten(state.opt_state.mu))
    rng = np.random.default_rng(6)
    tokens, _ = _batch(rng, 2, 32, cfg.vocab, False)
    batch = {"tokens": torch.from_numpy(tokens).long()}
    step = make_lm_train_step(cfg=cfg)
    first = float(step(state, batch)[1]["loss"])
    state, metrics = run_steps(step, state, [batch] * 5)
    assert state.step == 6 and float(metrics["loss"]) < first
    engine = make_engine(cfg, state.params, max_batch=2, max_len=64,
                         device="cpu")
    done = {}
    engine.submit_stream([int(t) for t in tokens[0, :12]],
                         lambda e: done.update(e) if e.get("done") else None,
                         max_new_tokens=4)
    engine.drain()
    assert len(done["tokens"]) == 4
    leaked = [name for name, t in vars(engine.state).items()
              if isinstance(t, torch.Tensor) and t.requires_grad]
    assert leaked == []
    assert engine.state.k.grad_fn is None
    assert all(p.grad is None for _, p in flatten(state.params))


def test_build_lm_auto_takes_the_plain_path_for_cpu_tensors():
    """``use_flash=None`` picks the kernels for CUDA tensors; on the CPU
    it is the plain reference, bit for bit."""
    cfg = LMConfig(dtype=torch.float32, attn_window=24, **SMALL)
    params = create_lm_state(build_lm(cfg), seed=3, device="cpu").params
    tokens = torch.from_numpy(_batch(np.random.default_rng(7), 2, 48,
                                     cfg.vocab, False)[0]).long()
    with torch.no_grad():
        auto = build_lm(cfg)(params, tokens)
        plain = build_lm(cfg, use_flash=False)(params, tokens)
        flash = build_lm(cfg, use_flash=True)(params, tokens)
    assert torch.equal(auto, plain)
    torch.testing.assert_close(flash, plain, **TOL32)


def test_meshless_step_runs_the_states_apply_fn():
    """Without a mesh the step computes through ``state.apply_fn`` on the
    state's parameters, so a wrapper around the model (one that keeps
    what the forward returns) sees every call and the result is the
    model's own."""
    cfg = LMConfig(dtype=torch.float32, **SMALL)
    tokens = torch.from_numpy(_batch(np.random.default_rng(5), 2, 16,
                                     cfg.vocab, False)[0]).long()
    want = create_lm_state(build_lm(cfg), seed=0, device="cpu")
    want, want_metrics = make_lm_train_step(cfg=cfg)(want,
                                                     {"tokens": tokens})
    calls = []

    class Wrapper:
        def __init__(self, model):
            self.model, self.cfg = model, model.cfg

        def __call__(self, params, *args, **kwargs):
            calls.append(params)
            return self.model(params, *args, **kwargs)

    state = create_lm_state(build_lm(cfg), seed=0, device="cpu")
    state.apply_fn = Wrapper(state.apply_fn)
    params = state.params
    state, metrics = make_lm_train_step(cfg=cfg)(state, {"tokens": tokens})
    assert len(calls) == 1 and calls[0] is params
    assert torch.equal(metrics["loss"], want_metrics["loss"])
    for (path, got), (_, ref) in zip(flatten(state.params),
                                     flatten(want.params)):
        assert torch.equal(got, ref), path


def test_segment_order_is_checked_once_per_forward():
    cfg = LMConfig(dtype=torch.float32, **SMALL)
    params = create_lm_state(build_lm(cfg, use_flash=True), seed=0,
                             device="cpu").params
    tokens = torch.zeros(1, 8, dtype=torch.long)
    unsorted = torch.tensor([[0, 0, 1, 1, 0, 2, 2, 2]])
    with pytest.raises(ValueError, match="non-decreasing"):
        build_lm(cfg, use_flash=True)(params, tokens, unsorted)


@pytest.mark.parametrize("entry", ["forward", "dq", "dkv"])
def test_public_flash_entries_refuse_unsorted_segment_ids(entry):
    """Unsorted ids would make the kernels' tile-skip predicate drop live
    tiles, so every public entry checks their order, not only
    flash_attention."""
    q = torch.zeros(1, 2, 8, 16)
    rows = torch.zeros(1, 2, 8)
    unsorted = torch.tensor([[0, 0, 1, 1, 0, 2, 2, 2]])
    call = {"forward": lambda: flash_forward(q, q, q, causal=True,
                                             segment_ids=unsorted),
            "dq": lambda: flash_dq(q, q, q, q, rows, rows, causal=True,
                                   segment_ids=unsorted),
            "dkv": lambda: flash_dkv(q, q, q, q, rows, rows, causal=True,
                                     segment_ids=unsorted)}[entry]
    with pytest.raises(ValueError, match="non-decreasing"):
        call()


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("round_o", [False, True], ids=["f32_o", "bf16_o"])
def test_smoke_rounded_delta_core_is_the_plain_backward(round_o):
    """chip_smoke's witness core: with the f32 O its hand-written backward
    is autograd of mha_reference (f32 inputs, TOL32); with O rounded to
    bf16 only delta moves, so dv stays exact and dq/dk move."""
    smoke = _load_smoke()
    rng = np.random.default_rng(8)
    q, k, v, do = (_t(rng.standard_normal((2, 4, 40, 16)).astype(np.float32))
                   for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = smoke.rounded_delta_attention(torch, round_o)(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(mha_reference(*plain, causal=True), plain, do)
    torch.testing.assert_close(out, mha_reference(q, k, v, causal=True),
                               **TOL32)
    torch.testing.assert_close(grads[2], ref[2], **TOL32)
    for g, r in zip(grads[:2], ref[:2]):
        if round_o:
            assert not torch.allclose(g, r, **TOL32)
            torch.testing.assert_close(g, r, atol=0.05, rtol=0.05)
        else:
            torch.testing.assert_close(g, r, **TOL32)


def test_smoke_twin_core_is_the_cpu_flash_path():
    """chip_smoke's twin core runs what flash_attention runs on CPU
    tensors (the twins in both directions): the same bits."""
    smoke = _load_smoke()
    rng = np.random.default_rng(9)
    q, k, v, do = (_t(rng.standard_normal((2, 4, 40, 16))).bfloat16()
                   for _ in range(4))
    twin = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = smoke.twin_attention(torch)(*twin)
    ref = flash_attention(*flash, causal=True)
    assert torch.equal(out, ref)
    for g, r in zip(torch.autograd.grad(out, twin, do),
                    torch.autograd.grad(ref, flash, do)):
        assert torch.equal(g, r)


def _mesh_shape(**axes):
    """A stand-in with only a mesh's axis sizes: the refusals read no
    more of the mesh than that."""
    shape = dict(dp=1, pp=1, fsdp=1, tp=1, sp=1, ep=1)
    shape.update(axes)
    return types.SimpleNamespace(shape=shape)


def test_unported_training_paths_raise():
    """Meshes train since the parallel slice (tests/
    test_torch_mesh_train.py), expert parallelism and MoE on a mesh
    since A10c (tests/test_torch_moe_mesh.py): an ep mesh's step builds
    and an MoE config's expert stacks go on ep. Since A10b a pp mesh
    builds too: outside the pipelined model (tests/
    test_torch_pipeline_*.py) pp is inert, no leaf placed on it. Since
    A11 nothing raises: the train-loop hooks run."""
    cfg = LMConfig(dtype=torch.float32, **SMALL)
    model = build_lm(cfg, mesh=_mesh_shape(dp=2, pp=2))
    assert not any("pp" in placement
                   for placement in model.placements.values())
    assert callable(make_lm_train_step(mesh=_mesh_shape(dp=2, pp=2),
                                       cfg=cfg))
    assert callable(make_lm_train_step(mesh=_mesh_shape(dp=2, ep=2),
                                       cfg=cfg))
    placements = lm_placements(LMConfig(moe_experts=2, **SMALL),
                               _mesh_shape(dp=4, ep=2))
    assert placements["block_1/moe/experts_up"][0] == "ep"
    assert placements["block_1/moe/router/kernel"] == ()
    # MoE training is ported (tests/test_torch_moe.py): its step builds.
    assert callable(make_lm_train_step(cfg=LMConfig(moe_experts=2, **SMALL)))
    # The train-loop hooks (A11) are ported: run_steps observes each step.
    state = create_lm_state(build_lm(cfg), seed=0, device="cpu")
    telemetry = StepTelemetry(flops_per_example=1e6, device_kind="cpu")
    tokens = torch.zeros(2, 8, dtype=torch.long)
    state, _ = run_steps(make_lm_train_step(cfg=cfg), state,
                         [{"tokens": tokens}] * 2, telemetry=telemetry)
    assert state.step == 2
    assert [(r["step"], r["batch_size"]) for r in telemetry.records] == [
        (0, 2), (1, 2)]

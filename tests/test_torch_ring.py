"""Ring attention (``kubeflow_tpu_torch/ops/ring.py``) against the JAX
package's (``kubeflow_tpu/ops/ring.py``) on its 8-device virtual CPU
mesh.

The port's ring runs in ONE gloo world of 8 ranks (``tests/
torch_world.py``, subprocesses of this file's fixture), every case of
``tests/test_ops.py::TestRingAttention`` in it: causal and non-causal at
sp=8, gradients through dp=2 x sp=4, sp composed with dp, a degenerate
sp=1 axis, packed segments spanning shards (against the reference ring,
``mha_reference`` and per-document attention, and their gradients), GQA
with a window and segments, and the ring's validation errors. Inputs
are numpy arrays from a seed, identical on both sides.

Tolerances: the reference tests' own (outputs 2e-5, gradients 5e-5,
absolute, f32). gloo and XLA sum in their own orders, so the ring is
held within them, not bitwise. The dead-hop skip is held to bits: a run
with every hop forced live must equal the skipping run exactly (a dead
hop folds exp(-1e30 - m) = 0 into the running sums), and the hops each
rank computes are counted.

The hop function alone (``ring_hop`` and ``hop_live`` over the shards
in one process, what ``chip_smoke.py`` drives at full width on the
card) is held against ``mha_reference`` without a world.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world
from kubeflow_tpu.ops import make_ring_attention as jmake_ring_attention
from kubeflow_tpu.ops import mha_reference as jmha_reference
from kubeflow_tpu.parallel import MeshSpec as JMeshSpec
from kubeflow_tpu.parallel import make_mesh as jmake_mesh
from kubeflow_tpu_torch.ops.attention import mha_reference
from kubeflow_tpu_torch.ops.ring import hop_live, ring_hop

OUT_ATOL, GRAD_ATOL = 2e-5, 5e-5


def qkv(b=2, h=2, s=256, d=64, seed=0, h_kv=None):
    rng = np.random.default_rng(seed)
    shapes = [(b, h, s, d)] + [(b, h_kv or h, s, d)] * 2
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in shapes)


def packed_segs(b, s):
    """Documents with boundaries off the shard grid, as the reference
    test packs them (numpy seed 11)."""
    rng = np.random.default_rng(11)
    out = np.zeros((b, s), np.int32)
    for row in range(b):
        cuts = sorted(rng.choice(np.arange(8, s - 8), 3, replace=False))
        for i, c in enumerate(cuts):
            out[row, c:] = i + 1
    return out


# name: (mesh spec, inputs, causal, window, segments, gradient)
CASES = {
    "plain_sp8": (dict(dp=1, sp=8), dict(), False, None, False, False),
    "causal_sp8": (dict(dp=1, sp=8), dict(), True, None, False, False),
    "grad_dp2_sp4": (dict(dp=2, sp=4), dict(s=128), True, None, False, True),
    "sp_with_dp": (dict(dp=2, sp=4), dict(b=4, s=128), True, None, False,
                   False),
    "sp1_dp8": (dict(dp=8, sp=1), dict(s=64), True, None, False, False),
    "segments_plain": (dict(dp=1, sp=8), dict(), False, None, True, False),
    "segments_causal": (dict(dp=1, sp=8), dict(), True, None, True, False),
    "segment_grads": (dict(dp=2, sp=4), dict(s=128), True, None, True, True),
    "gqa_window_segments": (dict(dp=1, sp=8),
                            dict(h=4, h_kv=2, d=32, seed=5), True, 48, True,
                            False),
    "gqa_dp2_sp4": (dict(dp=2, sp=4), dict(h=8, h_kv=2, s=64, d=16, seed=3),
                    True, None, False, False),
    "window_sp8": (dict(dp=1, sp=8), dict(), True, 40, False, False),
}
PER_DOCUMENT = np.repeat([0, 1], [96, 160])[None, :].astype(np.int32)
LIVE_ONLY = ("causal_sp8", "segments_causal", "gqa_window_segments",
             "window_sp8")


def _reference(spec, q, k, v, causal, window, seg, grad):
    """The JAX ring on its mesh, ``mha_reference``, and with ``grad``
    the reference ring's gradients of sum(out^2) in q, k, v."""
    mesh = jmake_mesh(JMeshSpec(**spec))
    ring = jmake_ring_attention(mesh, "sp", window=window)
    seg_j = None if seg is None else jnp.asarray(seg)

    def run(q, k, v):
        return ring(q, k, v, causal=causal, segment_ids=seg_j)

    q, k, v = (jnp.asarray(x) for x in (q, k, v))
    out = {"ring": np.asarray(run(q, k, v)),
           "dense": np.asarray(jmha_reference(q, k, v, causal=causal,
                                              window=window,
                                              segment_ids=seg_j))}
    if grad:
        out["grads"] = [np.asarray(g) for g in jax.jit(jax.grad(
            lambda q, k, v: (run(q, k, v) ** 2).sum(),
            argnums=(0, 1, 2)))(q, k, v)]
    return out


@pytest.fixture(scope="module")
def ring_world(tmp_path_factory):
    """The world runs while the reference computes."""
    tasks, inputs = [], {}
    for name, (spec, shape, causal, window, segd, grad) in CASES.items():
        q, k, v = qkv(**shape)
        seg = packed_segs(q.shape[0], q.shape[2]) if segd else None
        inputs[name] = (spec, q, k, v, causal, window, seg, grad)
        kw = dict(spec=spec, q=q, k=k, v=v, causal=causal, window=window,
                  segment_ids=seg, grad=grad)
        tasks.append((f"ring:{name}", kw))
        if name in LIVE_ONLY:
            tasks.append((f"ring:{name}:live_only", {**kw,
                                                     "live_only": True}))
    q, k, v = qkv(b=1)
    tasks.append(("ring:per_document", dict(
        spec=dict(dp=1, sp=8), q=q, k=k, v=v, causal=True,
        segment_ids=PER_DOCUMENT)))
    refs = {"per_document": (q, k, v)}
    q, k, v = qkv(s=64, d=16)
    tasks.append(("ring_errors", dict(spec=dict(dp=2, sp=4), q=q, k=k, v=v)))
    world = torch_world.World(8, tasks, tmp_path_factory.mktemp("ring"))
    for name, args in inputs.items():
        refs[name] = _reference(*args)
    return world.wait(), refs


def _assemble(results, name, key="out"):
    """The whole-sequence output (or a gradient) from the sp shards of
    dp index 0, and every dp replica's shards equal to it."""
    shards = {}
    for out in torch_world.outputs(results, name):
        value = out[key] if key == "out" else out["grads"][key]
        if out["dp"] == 0:
            shards[out["sp"]] = value
        else:
            np.testing.assert_array_equal(value, shards.get(out["sp"], value))
    return np.concatenate([shards[i] for i in sorted(shards)], axis=2)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_the_reference_ring_and_dense_attention(ring_world,
                                                             name):
    results, refs = ring_world
    got = _assemble(results, f"ring:{name}")
    np.testing.assert_allclose(got, refs[name]["ring"], atol=OUT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got, refs[name]["dense"], atol=OUT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", ["grad_dp2_sp4", "segment_grads"])
def test_ring_gradients_match_the_reference_ring(ring_world, name):
    """The reverse ring (Rotate's backward) brings every shard's k/v
    gradient home: q, k and v against ``jax.grad`` of the reference
    ring."""
    results, refs = ring_world
    for i, want in enumerate(refs[name]["grads"]):
        got = _assemble(results, f"ring:{name}", key=i)
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=0)


def test_packed_ring_equals_attention_per_document(ring_world):
    """Packing == attending to each document separately, a document
    spanning ring shards (96 | 160 over 8 shards of 32)."""
    results, refs = ring_world
    q, k, v = (torch.from_numpy(x) for x in refs["per_document"])
    got = _assemble(results, "ring:per_document")
    for lo, hi in ((0, 96), (96, 256)):
        doc = mha_reference(q[:, :, lo:hi], k[:, :, lo:hi], v[:, :, lo:hi],
                            causal=True).numpy()
        np.testing.assert_allclose(got[:, :, lo:hi], doc, atol=OUT_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("name", LIVE_ONLY)
def test_dead_hop_skip_changes_no_bit(ring_world, name):
    results, _ = ring_world
    skipping = torch_world.outputs(results, f"ring:{name}")
    live = torch_world.outputs(results, f"ring:{name}:live_only")
    for a, b in zip(skipping, live):
        np.testing.assert_array_equal(a["out"], b["out"])
        assert b["hops"] == [(a["sp"] - t) % 8 for t in range(8)]


def test_causal_ring_computes_only_the_hops_on_or_below_the_diagonal(
        ring_world):
    """Shard r computes hops from shards r, r-1, ..., 0 and skips the
    rest (on a causal ring that halves the average compute); a window
    of 40 over shards of 32 reaches two shards back (the first row of
    shard r sees position 32r - 39)."""
    results, _ = ring_world
    for causal, window, plain in zip(
            *(torch_world.outputs(results, f"ring:{name}")
              for name in ("causal_sp8", "window_sp8", "plain_sp8"))):
        r = causal["sp"]
        assert causal["hops"] == list(range(r, -1, -1))
        assert window["hops"] == list(range(r, max(r - 3, -1), -1))
        assert len(plain["hops"]) == 8


def test_ring_attention_validation(ring_world):
    results, _ = ring_world
    every = torch_world.outputs(results, "ring_errors")
    errors = every[0]
    assert ">= 1" in errors["window0"]
    assert "causal" in errors["window_not_causal"]
    assert "multiple" in errors["heads"]
    assert "attn_window" in errors["config"]
    assert all(out == errors for out in every)


# ------------------------------------------------ the hop function alone


@pytest.mark.parametrize("causal,window,segd,h_kv", [
    (True, None, False, 2), (True, 24, False, 1), (True, None, True, 2),
    (False, None, True, 4), (False, None, False, 4)])
def test_hops_over_the_shards_in_one_process_match_attention(causal, window,
                                                             segd, h_kv):
    """``ring_hop`` driven over 4 source shards for each query shard,
    dead hops skipped by ``hop_live``, in one process: what the card's
    smoke runs at S=8192; here against ``mha_reference`` (f32)."""
    n, s_local = 4, 32
    q, k, v = (torch.from_numpy(x) for x in qkv(b=2, h=4, s=n * s_local,
                                                 d=16, h_kv=h_kv))
    seg = torch.from_numpy(packed_segs(2, n * s_local)) if segd else None
    want = mha_reference(q, k, v, causal=causal, window=window,
                         segment_ids=seg)
    b, h, _, d = q.shape

    def shard(t, i, dim=2):
        return t.narrow(dim, i * s_local, s_local)

    def rng(i):
        if seg is None:
            return None
        return [shard(seg, i, 1).amin(1).tolist(),
                shard(seg, i, 1).amax(1).tolist()]

    for i in range(n):
        qg = shard(q, i).reshape(b, h_kv, h // h_kv, s_local, d)
        o = torch.zeros(qg.shape)
        m = torch.full(qg.shape[:-1] + (1,), -1e30)
        carry = (o, m, torch.zeros_like(m))
        for src in range(n):
            if hop_live(i, src, s_local, causal, window, rng(i), rng(src)):
                carry = ring_hop(
                    qg, shard(k, src), shard(v, src), carry, q_index=i,
                    src=src, s_local=s_local, scale=d ** -0.5,
                    causal=causal, window=window,
                    seg_q=None if seg is None else shard(seg, i, 1),
                    seg_k=None if seg is None else shard(seg, src, 1))
        got = (carry[0] / carry[2]).reshape(b, h, s_local, d)
        np.testing.assert_allclose(got.numpy(), shard(want, i).numpy(),
                                   atol=OUT_ATOL, rtol=0)

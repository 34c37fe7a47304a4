"""The pipeline layer's single-process parts against the JAX package:
``kubeflow_tpu_torch/parallel/schedule1f1b.py`` (the port's own copy),
the static tables and layouts of ``parallel/pipeline.py``, and
``models/pipeline_lm.py``'s validations, placements and sequential
reference.

- The interleaved 1F1B tables equal the reference's array for array
  over the configs of ``tests/test_pipeline.py``'s
  ``TestInterleaved1F1B`` schedule test, as do the plain 1F1B tables, and the
  port's executor form of the plain tables passes the independent
  checker.
- ``pipeline_ticks``, ``stage_stack`` and ``stage_stack_interleaved``
  (layout and errors), the engines' and ``PipelinedLM``'s validation
  errors (``TestGpipeEngine``, ``TestInterleavedGpipe``,
  ``TestPipelinedLM``, ``TestInterleavedLM``), built on a mesh that
  needs no world (``parallel.Mesh`` from a spec and a rank).
- ``pp_param_sharding`` gives every leaf of the pipelined layout the
  reference's PartitionSpec on dp2 x pp4, dp2 x pp2 x tp2 and
  pp2 x fsdp2 x tp2 (``test_pp_param_sharding_non_block_leaves_
  canonical`` and more).
- ``sequential_apply`` on the reference's parameters equals the
  reference's ``sequential_apply`` (f32, logits 1e-4 absolute, the
  reference tests' own limit), packed and windowed.

The schedules on ranks are ``tests/test_torch_pipeline_engines.py``; the
pipelined LM on meshes ``tests/test_torch_pipeline_lm.py``,
``tests/test_torch_pipeline_1f1b.py`` and
``tests/test_torch_pipeline_ckpt.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.pipeline_lm import PipelinedLM as JPipelinedLM
from kubeflow_tpu.models.pipeline_lm import (
    pp_param_sharding as jpp_param_sharding,
)
from kubeflow_tpu.models.transformer import LMConfig as JLMConfig
from kubeflow_tpu.parallel import MeshSpec as JMeshSpec
from kubeflow_tpu.parallel import make_mesh as jmake_mesh
from kubeflow_tpu.parallel import pipeline as jpipeline
from kubeflow_tpu.parallel import schedule1f1b as jschedule
from kubeflow_tpu_torch.models import LMConfig, params_from_jax
from kubeflow_tpu_torch.models.pipeline_lm import (
    PipelinedLM,
    pp_param_sharding,
    stacked_specs,
)
from kubeflow_tpu_torch.parallel import (
    Mesh,
    MeshSpec,
    gpipe,
    interleaved_gpipe,
    interleaved_one_f_one_b,
    one_f_one_b,
    pipeline_ticks,
    stage_stack,
    stage_stack_interleaved,
)
from kubeflow_tpu_torch.parallel import pipeline, schedule1f1b

SCHEDULE_CONFIGS = [(8, 4, 2), (8, 4, 1), (4, 4, 2), (8, 2, 4), (12, 4, 3),
                    (16, 8, 2), (32, 4, 2)]
TABLES = ("action", "unit_v", "unit_m", "f_in", "b_in", "b_cot",
          "act_store", "cot_store")


def _mesh(**axes) -> Mesh:
    """A mesh that needs no world: placements and validation only."""
    return Mesh(MeshSpec(**axes).resolve(8), torch.device("cpu"), {}, 0)


def _tokens(batch, seq, vocab=64, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(batch, seq))


# ------------------------------------------------------------ schedules


@pytest.mark.parametrize("m, p, v", SCHEDULE_CONFIGS)
def test_interleaved_schedule_equals_the_reference(m, p, v):
    """The port's copy builds the reference's tables array for array,
    its checker accepts them, and the buffer depth is O(P*V)."""
    got, want = schedule1f1b.build_schedule(m, p, v), \
        jschedule.build_schedule(m, p, v)
    schedule1f1b.check_schedule(got)
    for field in ("num_slots", "num_stages", "virtual_stages",
                  "num_microbatches", "xbuf_slots", "cbuf_slots"):
        assert getattr(got, field) == getattr(want, field), field
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.xbuf_slots <= p * (v + 2), (m, p, v)


def test_build_schedule_refuses_ragged_groups():
    with pytest.raises(ValueError, match="divide"):
        schedule1f1b.build_schedule(6, 4, 2)


@pytest.mark.parametrize("m, p", [(4, 4), (8, 4), (2, 4), (3, 4), (5, 2),
                                  (1, 1), (4, 1)])
def test_plain_1f1b_tables_equal_the_reference(m, p):
    """The closed-form tables are the reference's, and their executor
    form passes the interleaved schedule's independent checker."""
    got = pipeline._1f1b_tables(m, p)
    want = jpipeline._1f1b_tables(m, p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    plan = pipeline._plain_schedule(m, p)
    for name in TABLES:
        assert getattr(plan, name).shape == (2 * (m + p - 1), p), name
    if p > 1:   # the checker reads stage P-1's forwards as dropped ones
        plain = pipeline._plain_schedule(m, p)
        f = plain.action == 1
        last = np.zeros_like(f)
        last[:, p - 1] = True
        checked = schedule1f1b.Interleaved1F1B(**{
            **{k: getattr(plain, k) for k in (
                "num_slots", "num_stages", "virtual_stages",
                "num_microbatches", "xbuf_slots", "cbuf_slots", "b_in",
                "b_cot", "act_store", "cot_store")},
            "action": np.where(f & last, 0, plain.action),
            "unit_v": np.where(f & last, -1, plain.unit_v),
            "unit_m": np.where(f & last, -1, plain.unit_m),
            "f_in": np.where(f & last, -1, plain.f_in)})
        schedule1f1b.check_schedule(checked)


@pytest.mark.parametrize("m, p, v", [(4, 4, 1), (8, 4, 2), (3, 4, 1),
                                     (4, 1, 2), (6, 2, 3)])
def test_forward_plan_edges_agree_on_both_ends(m, p, v):
    """Every hop of the forward tick loop is live on both of its ends or
    on neither (the plan raises otherwise), and each rank runs every
    microbatch of every chunk once."""
    units, _ = pipeline._forward_plan(m, p, v)
    for d in range(p):
        ran = sorted(u for row in units for u in [row[d]] if u is not None)
        assert ran == sorted((c, j) for c in range(v) for j in range(m))


def test_ticks():
    assert pipeline_ticks(num_microbatches=4, num_stages=2) == 5
    assert pipeline_ticks(1, 1) == 1


# ------------------------------------------------------------ layouts


def test_stage_stack_layout_and_errors():
    stacked = stage_stack({"w": torch.arange(8).reshape(8, 1)}, 4)
    assert stacked["w"].shape == (4, 2, 1)
    # Contiguous layers per stage: stage 0 gets layers 0,1.
    assert stacked["w"][0].ravel().tolist() == [0, 1]
    with pytest.raises(ValueError, match="not divisible"):
        stage_stack({"w": torch.zeros((6, 1))}, 4)


def test_stage_stack_interleaved_is_the_reference_layout():
    """Global stage v*P + d at [d, v]: consecutive chunks on consecutive
    ranks, equal to the reference's restack."""
    w = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    for p, v in [(4, 2), (2, 4), (1, 2), (4, 1)]:
        got = stage_stack_interleaved(torch.from_numpy(w), p, v)
        want = jpipeline.stage_stack_interleaved(jnp.asarray(w), p, v)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    chunks = stage_stack_interleaved(
        torch.arange(8)[:, None] * torch.ones((8, 3)), 4, 2)
    for d in range(4):
        for v in range(2):
            assert float(chunks[d, v, 0, 0]) == v * 4 + d
    with pytest.raises(ValueError, match="chunks"):
        stage_stack_interleaved(torch.zeros((6, 2, 2)), 4, 2)


# ------------------------------------------------------------ validation


def test_engine_validation():
    mesh = _mesh(dp=2, pp=4)
    run = gpipe(lambda p, h: h, mesh, num_microbatches=4)
    with pytest.raises(ValueError, match="not divisible"):
        run(torch.zeros((1, 2, 2)), torch.zeros((6, 2)))
    chunk = lambda p, h: h   # noqa: E731
    for engine in (interleaved_gpipe, interleaved_one_f_one_b):
        with pytest.raises(ValueError, match="divisible by pp"):
            engine(chunk, mesh, num_microbatches=6, virtual_stages=2)
        with pytest.raises(ValueError, match="virtual_stages"):
            engine(chunk, mesh, num_microbatches=8, virtual_stages=0)
    with pytest.raises(ValueError, match="microbatch axis"):
        one_f_one_b(chunk, mesh, num_microbatches=4,
                    activation_spec=("sp", None))
    with pytest.raises(ValueError, match="replicated|sharded"):
        gpipe(chunk, mesh, num_microbatches=4, output="gathered")
    with pytest.raises(ValueError, match="divisible by pp"):
        one_f_one_b(chunk, mesh, num_microbatches=2, output="sharded")
    with pytest.raises(ValueError, match="leading dim is 1"):
        gpipe(chunk, mesh, num_microbatches=2)(torch.zeros((4, 2)),
                                               torch.zeros((4, 2)))


def test_pipelined_lm_validation():
    """``TestPipelinedLM::test_validation`` and
    ``TestInterleavedLM::test_validation``, and the schedule checks."""
    mesh = _mesh(dp=2, pp=4)
    cfg = LMConfig(vocab=64, layers=4, dim=32, heads=2)
    with pytest.raises(ValueError, match="divisible"):
        PipelinedLM(LMConfig(vocab=64, layers=6, dim=32, heads=2), mesh,
                    num_microbatches=2)
    with pytest.raises(ValueError, match="MoE"):
        PipelinedLM(LMConfig(vocab=64, layers=4, dim=32, heads=2,
                             moe_experts=2), mesh, num_microbatches=2)
    with pytest.raises(ValueError, match="Megatron"):
        PipelinedLM(LMConfig(vocab=64, layers=4, dim=512, heads=8,
                             kv_heads=2), _mesh(dp=1, pp=2, tp=4),
                    num_microbatches=2)
    eight = LMConfig(vocab=64, layers=8, dim=32, heads=2)
    with pytest.raises(ValueError, match="chunks"):
        PipelinedLM(eight, mesh, num_microbatches=4, schedule="interleaved",
                    virtual_stages=3)
    with pytest.raises(ValueError, match="virtual_stages"):
        PipelinedLM(eight, mesh, num_microbatches=4, virtual_stages=2)
    with pytest.raises(ValueError, match="remat"):
        PipelinedLM(cfg, mesh, num_microbatches=4, schedule="1f1b",
                    remat=True)
    with pytest.raises(ValueError, match="gpipe|1f1b|interleaved"):
        PipelinedLM(cfg, mesh, num_microbatches=4, schedule="zb")
    model = PipelinedLM(cfg, mesh, num_microbatches=2)
    assert model.output == "replicated"
    assert PipelinedLM(cfg, mesh, num_microbatches=8).output == "sharded"


# ------------------------------------------------------------ placements


@pytest.mark.parametrize("axes", [dict(dp=2, pp=4), dict(dp=2, pp=2, tp=2),
                                  dict(dp=1, pp=2, fsdp=2, tp=2)])
def test_pp_param_sharding_matches_the_reference(axes):
    """Every leaf of the pipelined layout (a config big enough for fsdp
    to shard) takes the reference's PartitionSpec: blocks on pp, tp on
    the stack-shifted kernel dim, fsdp on the largest other dim; the
    embedding and final norm by the plain rule (pp inert)."""
    cfg = LMConfig(vocab=256, layers=4, dim=128, heads=4)
    jmesh = jmake_mesh(JMeshSpec(**axes))
    model = PipelinedLM(cfg, _mesh(**axes), num_microbatches=2)
    for path, shape in stacked_specs(cfg):
        keys = tuple(jax.tree_util.DictKey(k) for k in path.split("/"))
        want = jpp_param_sharding(jmesh, keys, jax.ShapeDtypeStruct(
            shape, jnp.float32)).spec
        got = model.placements[path]
        assert got == tuple(want) + (None,) * (len(got) - len(want)) \
            or (got == () and tuple(want) == ()), (path, got, want)
        assert pp_param_sharding(model.mesh, tuple(path.split("/")),
                                 torch.empty(shape, device="meta")) == got
    assert model.placements["blocks/q_proj/kernel"][0] == "pp"


def test_pp_param_sharding_non_block_leaves_canonical():
    mesh = _mesh(dp=2, pp=4)
    assert pp_param_sharding(mesh, ("embed", "embedding"),
                             torch.empty((64, 32), device="meta")) == ()


# ------------------------------------------------------------ sequential


SEQ_CASES = {
    "plain": (dict(vocab=64, layers=4, dim=32, heads=2), False),
    "packed": (dict(vocab=64, layers=4, dim=32, heads=2), True),
    "window_gqa": (dict(vocab=64, layers=2, dim=32, heads=4, kv_heads=2,
                        attn_window=4), True),
}


@pytest.mark.parametrize("name", sorted(SEQ_CASES))
def test_sequential_apply_matches_the_reference(name):
    """The port's sequential reference on the reference's parameters
    (its own init, carried across as numpy) equals the reference's
    ``sequential_apply``."""
    cfg_kw, packed = SEQ_CASES[name]
    jmodel = JPipelinedLM(JLMConfig(**cfg_kw),
                          jmake_mesh(JMeshSpec(dp=4, pp=2)),
                          num_microbatches=2)
    params = jmodel.init(jax.random.key(0))
    tokens = _tokens(4, 16)
    seg = None
    if packed:
        seg = np.zeros((4, 16), np.int32)
        seg[:, 6:] = 1
        seg[1:, 11:] = 2
    want = np.asarray(jax.jit(lambda p, t, s: jmodel.sequential_apply(
        {"params": p}, t, s))(params, jnp.asarray(tokens),
                              None if seg is None else jnp.asarray(seg)))
    cfg = LMConfig(**cfg_kw)
    model = PipelinedLM(cfg, _mesh(dp=4, pp=2), num_microbatches=2,
                        use_flash=False)
    whole = params_from_jax(cfg, jax.tree.map(np.asarray, params),
                            device="cpu", dtype=torch.float32)
    with torch.no_grad():
        got = model.sequential_apply(
            whole, torch.from_numpy(tokens),
            None if seg is None else torch.from_numpy(seg)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

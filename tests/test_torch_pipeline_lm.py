"""The pipelined LM (``kubeflow_tpu_torch/models/pipeline_lm.py`` over
``parallel/pipeline.py``) against the JAX package's on its 8-device
virtual CPU mesh: ``tests/test_pipeline.py``'s ``TestPipelinedLM``
(dp2 x pp4; remat; the state born pp-sharded; pp x tp; the window) and
``TestPipelineSequenceParallel`` (pp2 x sp4, windowed too), GPipe with
M = 2 < P, so the output is replicated over pp; and dp2 x pp2 x fsdp2,
whose blocks the reference shards over fsdp too.

One gloo world of 8 ranks (``tests/torch_world.py`` ``case_pp_lm``,
``case_pp_born``) runs the port from the reference's own init (carried
across as numpy, laid onto the port's mesh by ``shard_state``, which
takes ``pp_param_sharding``'s placements from the model) while the
pytest process computes the reference's logits and its train step (its
gradients recorded by an optax transformation ahead of its AdamW) on the
same tokens. The step's optimizer is the mesh tests' f32 AdamW
(``F32_ADAMW``: lr 0.1, eps 1e-3, f32 moments), whose first step is
smooth in the gradient.

Tolerances (f32), ``tests/test_torch_mesh_train.py``'s: logits 1e-4
absolute at each rank's rows and sp columns (the reference tests' own);
the loss 1e-5 relative; each leaf's gradient and each leaf's update
1e-4 in relative norm; remat against no remat 1e-5 absolute (the
reference test's bound); every rank's forward also against the port's
own ``sequential_apply`` at 1e-4.

The harness here (:class:`PPCase`, :func:`pp_world` and the checks) is
shared with ``tests/test_torch_pipeline_1f1b.py`` and
``tests/test_torch_pipeline_packed.py``. A hang fails the world's wait.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_world
from kubeflow_tpu.models.pipeline_lm import PipelinedLM as JPipelinedLM
from kubeflow_tpu.models.pipeline_lm import (
    create_pp_lm_state as jcreate_pp_lm_state,
)
from kubeflow_tpu.models.pipeline_lm import (
    make_pp_lm_train_step as jmake_pp_lm_train_step,
)
from kubeflow_tpu.models.transformer import LMConfig as JLMConfig
from kubeflow_tpu.parallel import MeshSpec as JMeshSpec
from kubeflow_tpu.parallel import make_mesh as jmake_mesh
from test_torch_mesh_train import (
    F32_ADAMW,
    GRAD_RTOL,
    LOGITS_ATOL,
    LOSS_RTOL,
    UPDATE_RTOL,
    _flat,
    _np_tree,
    _recording_adamw,
    update_errors,
)


@dataclasses.dataclass(frozen=True)
class PPCase:
    """One pipelined-LM case: the mesh, config and ``PipelinedLM``
    keywords, the batch shape and packing (None, ``"fixed"`` or a seed),
    what the reference computes on its mesh (``"forward"``, ``"step"``)
    or whose reference it shares (``ref``: the same function of the same
    parameters and batch on another mesh or schedule), and
    ``case_pp_lm``'s other keywords."""

    spec: dict
    cfg: dict
    model: dict
    batch: tuple
    seg: object = None
    jax: tuple = ()
    ref: str | None = None
    kw: dict = dataclasses.field(default_factory=dict)

    @property
    def steps(self) -> int:
        return self.kw.get("steps", 1)


def tokens_for(case: PPCase) -> np.ndarray:
    return np.random.default_rng(0).integers(0, case.cfg["vocab"],
                                             size=case.batch)


def segments_for(case: PPCase):
    b, s = case.batch
    if case.seg is None:
        return None
    if case.seg == "fixed":   # the reference test's two-document rows
        return np.repeat([[0, 1]], [7, 9], axis=1).repeat(b, axis=0).astype(
            np.int32)
    rng = np.random.default_rng(case.seg)
    out = np.zeros((b, s), np.int32)
    for row in range(b):
        cuts = sorted(rng.choice(np.arange(2, s - 2), 2, replace=False))
        out[row, cuts[0]:cuts[1]] = 1
        out[row, cuts[1]:] = 2
    return out


def _cfg_key(cfg: dict) -> tuple:
    return tuple(sorted(cfg.items()))


def pp_world(cases: dict, tmp, extra_tasks=()):
    """The reference's init per config first (parameters depend on the
    config alone), the world started on them, then the reference's
    forwards and steps while it runs. Returns (results, refs)."""
    inits, tasks = {}, []
    for name, case in cases.items():
        key = _cfg_key(case.cfg)
        if key not in inits:
            jmodel = JPipelinedLM(JLMConfig(**case.cfg),
                                  jmake_mesh(JMeshSpec(dp=-1)),
                                  num_microbatches=1)
            inits[key] = _np_tree(jax.jit(jmodel.init)(jax.random.key(0)))
        tasks.append((f"pp_lm:{name}", dict(
            spec=case.spec, cfg=case.cfg, model=case.model,
            params=inits[key], tokens=tokens_for(case),
            segment_ids=segments_for(case), adamw=F32_ADAMW, **case.kw)))
    world = torch_world.World(8, list(tasks) + list(extra_tasks), tmp)
    refs = {name: _jax_refs(case) for name, case in cases.items()
            if case.jax}
    refs["params"] = inits
    return world.wait(), refs


def _jax_refs(case: PPCase) -> dict:
    mesh = jmake_mesh(JMeshSpec(**case.spec))
    model = JPipelinedLM(JLMConfig(**case.cfg), mesh, **case.model)
    state = jcreate_pp_lm_state(model, jax.random.key(0),
                                tx=_recording_adamw(mu_dtype=None,
                                                    **F32_ADAMW))
    tokens = jnp.asarray(tokens_for(case))
    seg = segments_for(case)
    seg = None if seg is None else jnp.asarray(seg)
    out = {"shards": {path: {s.device.id: np.asarray(s.data)
                             for s in leaf.addressable_shards}
                      for path, leaf in _flat_arrays(state.params).items()},
           "specs": {path: tuple(leaf.sharding.spec) for path, leaf
                     in _flat_arrays(state.params).items()}}
    if "forward" in case.jax:
        out["logits"] = np.asarray(jax.jit(
            lambda p, t, s: model.apply({"params": p}, t, s))(
                state.params, tokens, seg))
    if "step" in case.jax:
        batch = {"tokens": tokens}
        if seg is not None:
            batch["segment_ids"] = seg
        new, metrics = jmake_pp_lm_train_step(model)(state, batch)
        out.update(loss=float(metrics["loss"]),
                   grads=_flat(new.opt_state[0]), after=_flat(new.params))
    return out


def _flat_arrays(tree):
    from kubeflow_tpu.parallel.mesh import path_key

    return {"/".join(path_key(p) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def reference(refs: dict, cases: dict, name: str) -> dict:
    case = cases[name]
    return refs[case.ref or name]


def check_forward(results, refs, cases, name, want=None):
    """Every rank's logits against the reference's at its rows and sp
    columns."""
    want = reference(refs, cases, name)["logits"] if want is None else want
    for out in torch_world.outputs(results, f"pp_lm:{name}"):
        r0, r1 = out["row_range"]
        c0, c1 = out["col_range"]
        np.testing.assert_allclose(out["logits"], want[r0:r1, c0:c1],
                                   atol=LOGITS_ATOL, rtol=0,
                                   err_msg=f"{name} rank {out['rank']}")


def check_step(results, refs, cases, name):
    """The first step's loss (every rank the same), whole gradients and
    updates against the reference's step."""
    want = reference(refs, cases, name)
    outs = torch_world.outputs(results, f"pp_lm:{name}")
    losses = {out["losses"][0] for out in outs}
    assert len(losses) == 1, losses
    loss = losses.pop()
    assert abs(loss - want["loss"]) <= LOSS_RTOL * abs(want["loss"]), (
        loss, want["loss"])
    got = outs[0]
    assert sorted(got["grads"]) == sorted(want["grads"])
    for path, g in got["grads"].items():
        err = np.linalg.norm(g - want["grads"][path]) / np.linalg.norm(
            want["grads"][path])
        assert err <= GRAD_RTOL, (name, path, err)
    before = _flat(refs["params"][_cfg_key(cases[name].cfg)])
    for out in outs:
        errs = update_errors(out["params"], want["after"], before)
        worst = max(errs.items(), key=lambda kv: kv[1])
        assert worst[1] <= UPDATE_RTOL, (name, worst)


# ------------------------------------------------------------- cases

CFG4 = dict(vocab=64, layers=4, dim=32, heads=2)
SP_CFG = dict(vocab=64, layers=2, dim=32, heads=4, kv_heads=2)
DP2_PP4 = dict(dp=2, pp=4)
PP2_SP4 = dict(dp=1, pp=2, sp=4)
M2 = dict(num_microbatches=2)

CASES = {
    # TestPipelinedLM: forward and gradients, dp2 x pp4
    "dp2_pp4": PPCase(DP2_PP4, CFG4, M2, (4, 16), jax=("forward", "step"),
                      kw=dict(sequential=True)),
    # TestPipelinedLM::test_remat_matches
    "dp2_pp4_remat": PPCase(DP2_PP4, CFG4, dict(M2, remat=True), (4, 16),
                            ref="dp2_pp4", kw=dict(forward=False)),
    # TestPipelinedLM::test_composes_with_tp: dp2 x pp2 x tp2
    "dp2_pp2_tp2": PPCase(dict(dp=2, pp=2, tp=2), CFG4, M2, (4, 16),
                          jax=("step",), kw=dict(forward=False)),
    # pp x fsdp: the blocks' fsdp shards gathered a layer at a time
    "dp2_pp2_fsdp2": PPCase(dict(dp=2, pp=2, fsdp=2), dict(CFG4, dim=128),
                            M2, (8, 16), jax=("step",),
                            kw=dict(forward=False)),
    # test_windowed_pipelined_lm_differs_from_full_and_matches_sequential
    "window_dp2_pp4": PPCase(DP2_PP4, dict(CFG4, attn_window=4), M2,
                             (4, 16), jax=("forward",),
                             kw=dict(steps=0, window_off=True,
                                     sequential=True)),
    # TestPipelineSequenceParallel: pp2 x sp4, forward, grads, descends
    "pp2_sp4": PPCase(PP2_SP4, SP_CFG, M2, (4, 32), jax=("forward", "step"),
                      kw=dict(steps=2, sequential=True)),
    # TestPipelineSequenceParallel::test_windowed_sp_pipeline
    "window_pp2_sp4": PPCase(PP2_SP4, dict(SP_CFG, attn_window=8), M2,
                             (4, 32), jax=("forward",), kw=dict(steps=0)),
}
FORWARD = sorted(n for n, c in CASES.items() if c.kw.get("forward", True)
                 and "forward" in CASES[c.ref or n].jax)
STEPS = sorted(n for n, c in CASES.items() if c.steps
               and "step" in CASES[c.ref or n].jax)


@pytest.fixture(scope="module")
def lm_world(tmp_path_factory):
    born = ("pp_born", dict(spec=DP2_PP4, cfg=CFG4, model=M2,
                            tokens=tokens_for(CASES["dp2_pp4"])))
    return pp_world(CASES, tmp_path_factory.mktemp("pp_lm"), [born])


@pytest.mark.parametrize("name", FORWARD)
def test_forward_matches_the_reference(lm_world, name):
    results, refs = lm_world
    check_forward(results, refs, CASES, name)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items()
                                        if c.kw.get("sequential")))
def test_forward_matches_the_port_sequential_apply(lm_world, name):
    """The schedules are an execution layout: every rank's rows equal
    ``sequential_apply`` on the whole parameters."""
    results, _ = lm_world
    outs = torch_world.outputs(results, f"pp_lm:{name}")
    seq = outs[0]["sequential"]
    check_forward(results, {}, {name: CASES[name]}, name, want=seq)


@pytest.mark.parametrize("name", STEPS)
def test_step_matches_the_reference(lm_world, name):
    results, refs = lm_world
    check_step(results, refs, CASES, name)


def test_remat_matches(lm_world):
    """remat recomputes stage internals: the same gradients (1e-5)."""
    results, _ = lm_world
    plain = torch_world.outputs(results, "pp_lm:dp2_pp4")[0]["grads"]
    remat = torch_world.outputs(results, "pp_lm:dp2_pp4_remat")[0]["grads"]
    worst = max(float(np.max(np.abs(plain[p] - remat[p]))) for p in plain)
    assert worst < 1e-5


def test_state_born_pp_sharded_and_step_runs(lm_world):
    """``create_pp_lm_state``: blocks leaves on pp (each rank its
    (layers/P, ...) slice), the rest by the plain rule; two steps on one
    batch descend."""
    results, _ = lm_world
    for out in torch_world.outputs(results, "pp_born"):
        assert out["placements"]["blocks/q_proj/kernel"][0] == "pp"
        assert out["shapes"]["blocks/q_proj/kernel"] == (1, 32, 32)
        assert out["placements"]["embed/embedding"] == ()
        assert out["apply_fn"] == "PipelinedLM"
        loss0, loss1 = out["losses"]
        assert np.isfinite(loss0) and loss1 < loss0
        assert out["step"] == 2


def test_composes_with_tp_like_the_reference_devices(lm_world):
    """dp2 x pp2 x tp2: the stacked q_proj kernel on ('pp', None, 'tp'),
    proj's input dim on tp, and each rank's shard of every leaf equal to
    the reference's shard on the same device."""
    results, refs = lm_world
    want = refs["dp2_pp2_tp2"]
    for out in torch_world.outputs(results, "pp_lm:dp2_pp2_tp2"):
        q = out["placements"]["blocks/q_proj/kernel"]
        assert q[0] == "pp" and q[2] == "tp"
        assert out["placements"]["blocks/proj/kernel"][1] == "tp"
        for path, local in out["shards"].items():
            np.testing.assert_array_equal(
                local, want["shards"][path][out["rank"]], err_msg=path)


def test_window_flows_into_the_pipelined_blocks(lm_world):
    """The windowed model matches its reference (above) and differs
    from the full-causal model on the same parameters."""
    results, _ = lm_world
    for out in torch_world.outputs(results, "pp_lm:window_dp2_pp4"):
        assert float(np.max(np.abs(out["logits"] - out["logits_full"]))) \
            > 1e-3


def test_sp_pipeline_train_step_descends(lm_world):
    results, _ = lm_world
    for out in torch_world.outputs(results, "pp_lm:pp2_sp4"):
        loss0, loss1 = out["losses"]
        assert np.isfinite(loss0) and loss1 < loss0

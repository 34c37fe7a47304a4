"""The pipelined LM's other schedules against the JAX package's on its
8-device virtual CPU mesh: ``tests/test_pipeline.py``'s ``TestOneFOneB``
(the LM on 1F1B, with sp, the step descending), ``TestInterleavedLM``
(virtual stages: forward, gradients, packed, remat, with sp) and
``TestInterleaved1F1B`` (the LM on interleaved 1F1B, packed without sp,
with sp), M = 4 microbatches: divisible by pp4, so the output is
sharded over pp and each stage runs the head on its own microbatches,
except on pp2 x sp2 at M = 2 (sharded too).

One gloo world of 8 ranks runs the port (``tests/torch_world.py``
``case_pp_lm``); the harness, the f32 AdamW and the tolerances are
``tests/test_torch_pipeline_lm.py``'s (logits 1e-4 absolute, loss 1e-5
relative, gradients and updates 1e-4 in relative norm, remat 1e-5
absolute). Where a case is the same function of the same parameters and
batch as another on another mesh (the sp meshes), it is held against
that case's reference. A hang fails the world's wait.
"""

from __future__ import annotations

import numpy as np
import pytest

import torch_world
from test_torch_pipeline_lm import (
    PPCase,
    check_forward,
    check_step,
    pp_world,
)

CFG4 = dict(vocab=64, layers=4, dim=32, heads=2)
CFG8 = dict(vocab=64, layers=8, dim=32, heads=2)
DP2_PP4 = dict(dp=2, pp=4)
PP4_SP2 = dict(dp=1, pp=4, sp=2)
ONE_F = dict(num_microbatches=4, schedule="1f1b")
INTERLEAVED = dict(num_microbatches=4, schedule="interleaved",
                   virtual_stages=2)
ONE_F_V2 = dict(num_microbatches=4, schedule="1f1b", virtual_stages=2)

CASES = {
    # TestOneFOneB::test_lm_1f1b_matches_sequential, ::test_1f1b_train_
    # step_descends (5 steps)
    "1f1b_dp2_pp4": PPCase(DP2_PP4, CFG4, ONE_F, (8, 16), jax=("step",),
                           kw=dict(steps=5, sequential=True)),
    # TestOneFOneB::test_lm_1f1b_composes_with_sp: loss and gradients
    "1f1b_pp4_sp2": PPCase(PP4_SP2, CFG4, ONE_F, (8, 16),
                           ref="1f1b_dp2_pp4", kw=dict(forward=False)),
    # TestInterleavedLM::test_forward_and_grads_match_sequential
    "interleaved_dp2_pp4": PPCase(DP2_PP4, CFG8, INTERLEAVED, (8, 16),
                                  jax=("forward", "step"),
                                  kw=dict(sequential=True)),
    # TestInterleavedLM::test_interleaved_remat_matches
    "interleaved_remat": PPCase(DP2_PP4, CFG8, dict(INTERLEAVED, remat=True),
                                (8, 16), ref="interleaved_dp2_pp4",
                                kw=dict(forward=False)),
    # TestInterleavedLM::test_packed_interleaved_matches_sequential
    "interleaved_packed": PPCase(DP2_PP4, CFG8, INTERLEAVED, (8, 16), seg=9,
                                 jax=("forward",), kw=dict(steps=0)),
    # TestInterleavedLM::test_interleaved_composes_with_sp_and_trains
    "interleaved_pp4_sp2": PPCase(PP4_SP2, CFG8, INTERLEAVED, (8, 16),
                                  ref="interleaved_dp2_pp4",
                                  kw=dict(steps=5, forward=False)),
    # TestInterleaved1F1B::test_lm_1f1b_virtual_matches_sequential
    "i1f1b_dp2_pp4": PPCase(DP2_PP4, CFG8, ONE_F_V2, (8, 16), jax=("step",),
                            kw=dict(forward=False)),
    # TestInterleaved1F1B::test_lm_packed_composes_without_sp
    "i1f1b_packed": PPCase(dict(dp=-1, pp=4), CFG8, ONE_F_V2, (8, 16),
                           seg="fixed", jax=("step",),
                           kw=dict(forward=False)),
    # TestInterleaved1F1B::test_1f1b_virtual_composes_with_sp (pp2 x sp2)
    "i1f1b_pp2_sp2": PPCase(dict(dp=2, pp=2, sp=2), CFG4,
                            dict(ONE_F_V2, num_microbatches=2), (4, 16),
                            jax=("forward", "step")),
}
FORWARD = sorted(n for n, c in CASES.items() if c.kw.get("forward", True)
                 and "forward" in CASES[c.ref or n].jax)
STEPS = sorted(n for n, c in CASES.items() if c.steps
               and "step" in CASES[c.ref or n].jax)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return pp_world(CASES, tmp_path_factory.mktemp("pp_1f1b"))


@pytest.mark.parametrize("name", FORWARD)
def test_forward_matches_the_reference(world, name):
    results, refs = world
    check_forward(results, refs, CASES, name)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items()
                                        if c.kw.get("sequential")))
def test_forward_matches_the_port_sequential_apply(world, name):
    results, _ = world
    seq = torch_world.outputs(results, f"pp_lm:{name}")[0]["sequential"]
    check_forward(results, {}, {name: CASES[name]}, name, want=seq)


@pytest.mark.parametrize("name", STEPS)
def test_step_matches_the_reference(world, name):
    results, refs = world
    check_step(results, refs, CASES, name)


@pytest.mark.parametrize("name", ["1f1b_dp2_pp4", "interleaved_pp4_sp2"])
def test_train_steps_descend(world, name):
    results, _ = world
    for out in torch_world.outputs(results, f"pp_lm:{name}"):
        assert np.all(np.isfinite(out["losses"]))
        assert out["losses"][-1] < out["losses"][0]


def test_interleaved_remat_matches(world):
    results, _ = world
    plain = torch_world.outputs(results,
                                "pp_lm:interleaved_dp2_pp4")[0]["grads"]
    remat = torch_world.outputs(results,
                                "pp_lm:interleaved_remat")[0]["grads"]
    worst = max(float(np.max(np.abs(plain[p] - remat[p]))) for p in plain)
    assert worst < 1e-5

"""Packed (document-masked) batches through the pipelined LM against
the JAX package's on its 8-device virtual CPU mesh: ``tests/
test_pipeline.py``'s ``TestPackedPipeline``. Segment ids microbatch
alongside the tokens as the schedules' per-microbatch side input; the
result must equal the reference's packed model, forward and backward,
on both schedules (dp2 x pp4, M = 4), with sp (pp4 x sp2: the segment-
aware ring inside every stage, the ids sharded over sp), differ from
the unpacked model, and train.

One gloo world of 8 ranks runs the port (``tests/torch_world.py``
``case_pp_lm``); the harness, the f32 AdamW and the tolerances are
``tests/test_torch_pipeline_lm.py``'s (logits 1e-4 absolute, loss 1e-5
relative, gradients and updates 1e-4 in relative norm). 1F1B and the sp
mesh compute the same function as GPipe on dp2 x pp4 and are held
against its reference. A hang fails the world's wait.
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
DP2_PP4 = dict(dp=2, pp=4)
PP4_SP2 = dict(dp=1, pp=4, sp=2)
GPIPE = dict(num_microbatches=4)
ONE_F = dict(num_microbatches=4, schedule="1f1b")

CASES = {
    # ::test_packed_matches_sequential, ::test_packed_grads_match_
    # sequential, ::test_packed_differs_from_unpacked (gpipe)
    "gpipe": PPCase(DP2_PP4, CFG4, GPIPE, (8, 16), seg=3,
                    jax=("forward", "step"),
                    kw=dict(unpacked=True, sequential=True)),
    # the same on 1F1B; ::test_packed_train_step_descends (5 steps)
    "1f1b": PPCase(DP2_PP4, CFG4, ONE_F, (8, 16), seg=3, ref="gpipe",
                   kw=dict(steps=5)),
    # ::test_packed_composes_with_sp, both schedules
    "gpipe_sp": PPCase(PP4_SP2, CFG4, GPIPE, (8, 16), seg=3, ref="gpipe"),
    "1f1b_sp": PPCase(PP4_SP2, CFG4, ONE_F, (8, 16), seg=3, ref="gpipe"),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return pp_world(CASES, tmp_path_factory.mktemp("pp_packed"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_forward_matches_the_reference(world, name):
    results, refs = world
    check_forward(results, refs, CASES, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_step_matches_the_reference(world, name):
    results, refs = world
    check_step(results, refs, CASES, name)


def test_packed_matches_the_port_sequential_apply(world):
    results, _ = world
    seq = torch_world.outputs(results, "pp_lm:gpipe")[0]["sequential"]
    check_forward(results, {}, {"gpipe": CASES["gpipe"]}, "gpipe", want=seq)


def test_packed_differs_from_unpacked(world):
    results, _ = world
    for out in torch_world.outputs(results, "pp_lm:gpipe"):
        assert float(np.max(np.abs(out["logits"]
                                   - out["logits_unpacked"]))) > 1e-3


def test_packed_train_step_descends(world):
    results, _ = world
    for out in torch_world.outputs(results, "pp_lm:1f1b"):
        assert np.all(np.isfinite(out["losses"]))
        assert out["losses"][-1] < out["losses"][0]

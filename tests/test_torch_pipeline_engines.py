"""The pipeline engines (``kubeflow_tpu_torch/parallel/pipeline.py``) on
toy stages, against the JAX package's engines on its 8-device virtual
CPU mesh: ``tests/test_pipeline.py``'s ``TestGpipeEngine``,
``TestOneFOneB``, ``TestInterleavedGpipe``, ``TestInterleaved1F1B`` and
``TestUniformCollectiveBackward`` cases.

One gloo world of 8 ranks (``tests/torch_world.py`` ``case_pp_engine``,
``case_pp_saved``) runs the port while the pytest process computes the
reference's outputs and gradients with its own engines (jitted) on the
same numpy inputs. Each rank holds its ``pp`` block of the stacked
weights (``stage_stack`` / ``stage_stack_interleaved``); with sharded
output its microbatch shard of y. The gradients are of sum(y^2): a
rank's stage gradient is held against its block of the reference's, its
x gradient (whole on every rank) against the whole one.

Tolerances: f32 at rtol 1e-5 / atol 1e-6 for outputs and gradients, as
the reference's own engine tests hold theirs (1e-5 for the forward
chain), and 1e-6 between the port's own V = 1 interleaved engine and
gpipe. The uniform-collective case (a toy stage with an sp rotation on
its datapath, pp2 x sp2) holds both 1F1B engines' gradients at 1e-5
against the reference gpipe's. Memory: the temporary bytes of one step,
forward and backward (``torch_world.AllocatorPeak``: the allocator's
high-water mark above the step's arguments, less its results, as
compiled temp bytes count) — interleaved 1F1B at M = 32 under 2.5x its
M = 8 and under interleaved gpipe's at M = 32, the reference's bounds.
A hang fails the world's wait.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_world
from kubeflow_tpu.parallel import MeshSpec as JMeshSpec
from kubeflow_tpu.parallel import gpipe as jgpipe
from kubeflow_tpu.parallel import interleaved_gpipe as jinterleaved_gpipe
from kubeflow_tpu.parallel import (
    interleaved_one_f_one_b as jinterleaved_one_f_one_b,
)
from kubeflow_tpu.parallel import make_mesh as jmake_mesh
from kubeflow_tpu.parallel import one_f_one_b as jone_f_one_b
from kubeflow_tpu.parallel import stage_stack as jstage_stack
from kubeflow_tpu.parallel import (
    stage_stack_interleaved as jstage_stack_interleaved,
)

RTOL, ATOL = 1e-5, 1e-6
DP2_PP4 = dict(dp=2, pp=4)
JAX_ENGINES = {"gpipe": jgpipe, "one_f_one_b": jone_f_one_b,
               "interleaved_gpipe": jinterleaved_gpipe,
               "interleaved_one_f_one_b": jinterleaved_one_f_one_b}


def _jax_stage(kind):
    def chunk(p, h):
        def layer(h, pw):
            return jnp.tanh(h @ pw), None
        h, _ = jax.lax.scan(layer, h, p)
        return h

    def sp_hop(p, h):
        def layer(h, pw):
            nbr = jax.lax.ppermute(h, "sp", [(i, (i + 1) % 2)
                                            for i in range(2)])
            return jnp.tanh(h @ pw + 0.5 * nbr), None
        h, _ = jax.lax.scan(layer, h, p)
        return h

    return {"affine": lambda p, h: h @ p + 1.0,
            "tanh": lambda p, h: jnp.tanh(h @ p),
            "chunk": chunk, "sp_hop": sp_hop}[kind]


def _stacked(w, layout, pp, virtual):
    if layout == "stack":
        return jstage_stack(w, pp)
    if layout == "interleaved":
        return jstage_stack_interleaved(w, pp, virtual)
    return w


def _block_of(arr, layout, pp, virtual, d):
    """Rank d's block of a whole (L, ...) array in the engine's layout."""
    arr = np.asarray(arr)
    if layout == "stack":
        arr = arr.reshape(pp, -1, *arr.shape[1:])
    elif layout == "interleaved":
        arr = arr.reshape(virtual, pp, -1, *arr.shape[1:]).swapaxes(0, 1)
    return arr[d]


def _weights(seed, shape, scale):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * scale).astype(np.float32)
    return w, rng


# name: (spec, engine, stage, layout, virtual, M, output, grad, seed,
#        w shape, w scale, x shape)
CASES = {
    # TestGpipeEngine::test_matches_sequential_stage_chain
    "gpipe_chain": (DP2_PP4, "gpipe", "affine", "plain", 1, 3, "replicated",
                    False, 1, (4, 8, 8), 0.1, (6, 8)),
    # TestOneFOneB::test_forward_matches_gpipe_and_sequential
    **{f"1f1b_fwd_{out}": (DP2_PP4, "one_f_one_b", "tanh", "plain", 1, 8,
                           out, False, 1, (4, 8, 8), 0.1, (16, 8))
       for out in ("replicated", "sharded")},
    # TestOneFOneB::test_grads_match_gpipe (M > P, M = P, M < P)
    **{f"1f1b_grads_m{m}": (DP2_PP4, "one_f_one_b", "tanh", "plain", 1, m,
                            "replicated", True, 2, (4, 8, 8), 0.1, (16, 8))
       for m in (4, 8, 2)},
    # TestInterleavedGpipe
    **{f"igpipe_v{v}_{out}": (DP2_PP4, "interleaved_gpipe", "chunk",
                              "interleaved", v, 8, out, v == 2
                              and out == "replicated", 3, (8, 8, 8), 0.1,
                              (16, 8))
       for v in (1, 2) for out in ("replicated", "sharded")},
    "gpipe_v1_twin": (DP2_PP4, "gpipe", "chunk", "stack", 1, 8, "replicated",
                      False, 3, (8, 8, 8), 0.1, (16, 8)),
    # TestInterleaved1F1B::test_forward_and_grads_match_sequential
    **{f"i1f1b_v{v}_{out}": (DP2_PP4, "interleaved_one_f_one_b", "chunk",
                             "interleaved", v, 8, out, True, 7, (8, 8, 8),
                             0.1, (16, 8))
       for v in (1, 2) for out in ("replicated", "sharded")},
    # The card's world: one pp stage (P = 1), every engine, V = 2 as a
    # ring of one.
    **{f"p1_{engine}": (dict(dp=8), engine, "chunk",
                        "interleaved" if engine.startswith("interleaved")
                        else "stack", 2 if engine.startswith("interleaved")
                        else 1, 4, "sharded", True, 5, (8, 8, 8), 0.2,
                        (8, 8))
       for engine in JAX_ENGINES},
}

# TestUniformCollectiveBackward: pp2 x sp2, an sp rotation on the
# datapath, x (4, 4, 8) sp-sharded on the microbatch rows.
UNIFORM = dict(spec=dict(dp=2, pp=2, sp=2), w=((4, 8, 8), 0.3),
               x=(4, 4, 8), M=2)
UNIFORM_RUNS = {"gpipe": ("gpipe", "stack", 1),
                "1f1b": ("one_f_one_b", "stack", 1),
                "1f1b_virtual": ("interleaved_one_f_one_b", "interleaved", 2)}


def _jax_case(spec, engine, stage, layout, virtual, m, output, grad, w, x,
              **kw):
    mesh = jmake_mesh(JMeshSpec(**spec))
    extra = {"virtual_stages": virtual} if engine.startswith(
        "interleaved") else {}
    run = JAX_ENGINES[engine](_jax_stage(stage), mesh, num_microbatches=m,
                              output=output, **extra, **kw)
    pp = spec.get("pp", 1)
    out = {"y": np.asarray(jax.jit(lambda w, x: run(
        _stacked(w, layout, pp, virtual), x))(w, x))}
    if grad:
        g_w, g_x = jax.jit(jax.grad(lambda w, x: jnp.sum(run(
            _stacked(w, layout, pp, virtual), x) ** 2), argnums=(0, 1)))(w, x)
        out.update(g_w=np.asarray(g_w), g_x=np.asarray(g_x))
    return out


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    tasks, inputs = [], {}
    for name, (spec, engine, stage, layout, virtual, m, output, grad, seed,
               wshape, scale, xshape) in CASES.items():
        w, rng = _weights(seed, wshape, scale)
        x = rng.normal(size=xshape).astype(np.float32)
        inputs[name] = (w, x)
        tasks.append((f"pp_engine:{name}", dict(
            spec=spec, engine=engine, stage=stage, w=w, x=x,
            num_microbatches=m, layout=layout, virtual=virtual,
            output=output, grad=grad)))
    uw, rng = _weights(0, *UNIFORM["w"])
    ux = rng.normal(size=UNIFORM["x"]).astype(np.float32)
    for name, (engine, layout, virtual) in UNIFORM_RUNS.items():
        tasks.append((f"pp_engine:uniform_{name}", dict(
            spec=UNIFORM["spec"], engine=engine, stage="sp_hop", w=uw, x=ux,
            num_microbatches=UNIFORM["M"], layout=layout, virtual=virtual,
            grad=True, sp_rows=True, sum_sp=True)))
    mw, _ = _weights(2, (8, 64, 64), 0.1)
    tasks.append(("pp_saved", dict(spec=dict(dp=2, pp=4), w=mw, rows=64,
                                   counts=[("interleaved_one_f_one_b", 8),
                                           ("interleaved_one_f_one_b", 32),
                                           ("interleaved_gpipe", 32)])))
    world = torch_world.World(8, tasks, tmp_path_factory.mktemp("pp_engines"))
    refs = {}
    for name, (spec, engine, stage, layout, virtual, m, output, grad, _,
               _, _, _) in CASES.items():
        refs[name] = _jax_case(spec, engine, stage, layout, virtual, m,
                               output, grad, *inputs[name])
    refs["uniform"] = _jax_case(
        UNIFORM["spec"], "gpipe", "sp_hop", "stack", 1, UNIFORM["M"],
        "replicated", True, uw, ux, activation_spec=P(None, "sp", None),
        extra_manual_axes=("sp",))
    return world.wait(), refs


def _rows(out, output):
    """The rows of the whole output a rank's y holds."""
    if output == "replicated":
        return slice(None)
    return slice(out["pp"] * out["rows"], (out["pp"] + 1) * out["rows"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_output_matches_the_reference(engines, name):
    results, refs = engines
    output = CASES[name][6]
    for out in torch_world.outputs(results, f"pp_engine:{name}"):
        want = refs[name]["y"][_rows(out, output)]
        np.testing.assert_allclose(out["y"], want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} pp {out['pp']}")


GRAD_CASES = sorted(n for n, c in CASES.items() if c[7])


@pytest.mark.parametrize("name", GRAD_CASES)
def test_engine_gradients_match_the_reference(engines, name):
    """Parameter AND input cotangents, every rank: its stage block and
    the whole x gradient (across warmup, steady state and cooldown for
    the 1F1B microbatch counts)."""
    results, refs = engines
    spec, _, _, layout, virtual, *_ = CASES[name]
    pp = spec.get("pp", 1)
    for out in torch_world.outputs(results, f"pp_engine:{name}"):
        want = _block_of(refs[name]["g_w"], layout, pp, virtual, out["pp"])
        np.testing.assert_allclose(out["g_block"], want, rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} dparams")
        np.testing.assert_allclose(out["g_x"], refs[name]["g_x"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} dx")


def test_interleaved_v1_equals_plain_gpipe(engines):
    """virtual_stages=1 degenerates to the plain schedule."""
    results, _ = engines
    for a, b in zip(torch_world.outputs(results,
                                        "pp_engine:igpipe_v1_replicated"),
                    torch_world.outputs(results, "pp_engine:gpipe_v1_twin")):
        np.testing.assert_allclose(a["y"], b["y"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(UNIFORM_RUNS))
def test_uniform_collective_backward_matches_gpipe(engines, name):
    """A toy stage with an sp rotation on its datapath: gpipe and both
    1F1B engines give the reference gpipe's gradients (the stage's
    summed over sp, x's at this rank's rows) at 1e-5."""
    results, refs = engines
    _, layout, virtual = UNIFORM_RUNS[name]
    m = UNIFORM["M"]
    g_x = refs["uniform"]["g_x"].reshape(m, -1, *UNIFORM["x"][1:])
    for out in torch_world.outputs(results, f"pp_engine:uniform_{name}"):
        want = _block_of(refs["uniform"]["g_w"], layout, 2, virtual,
                         out["pp"])
        np.testing.assert_allclose(out["g_block"], want, rtol=1e-5,
                                   atol=1e-6, err_msg=f"{name} dparams")
        part = g_x.shape[1] // 2
        j = out["sp"]
        want_x = g_x[:, j * part:(j + 1) * part].reshape(out["g_x"].shape)
        np.testing.assert_allclose(out["g_x"], want_x, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} dx")


def test_interleaved_1f1b_memory_is_bounded_in_microbatches(engines):
    """Growing M 4x (fixed microbatch rows) grows the scheduled step's
    temporary bytes, its backward's buffers and recompute graphs
    included, by under 2.5x, and it takes fewer than AD of the
    interleaved tick chain at the same M, on every rank. Microbatches of
    64 rows make activations outweigh the stage's weights, so a
    backward that kept every stage input (3.0x) or every recompute
    graph (3.5x) fails."""
    results, _ = engines
    for out in torch_world.outputs(results, "pp_saved"):
        small = out["interleaved_one_f_one_b:8"]
        large = out["interleaved_one_f_one_b:32"]
        ad_large = out["interleaved_gpipe:32"]
        assert large < 2.5 * small, (small, large)
        assert large < ad_large, (large, ad_large)

"""LM and ResNet training on dp/fsdp/tp/sp meshes: the port
(``kubeflow_tpu_torch/models/{transformer,train,resnet,convert}.py`` with
``parallel/``) against the JAX package on its 8-device virtual CPU mesh.

Two gloo worlds run the port (``tests/torch_world.py``, subprocesses of
this file's fixtures): 8 ranks for the LM cases and resnet18 at
dp=2 x fsdp=2 x tp=2, and 2 ranks formed by ``initialize_from_env`` from
``slice_env_for_rank``'s env for resnet18 at dp=2 and at fsdp=2. Every
case starts from the reference's own init (``create_lm_state`` /
``create_train_state`` on the reference mesh), carried across as numpy
and laid onto the port's mesh with ``shard_state``; inputs are numpy
arrays from a seed. The reference's gradients come from its own step: an
optax transformation chained ahead of its AdamW records them.

Cases, from ``tests/test_ops.py``, ``tests/test_parallel.py`` and
``tests/test_models.py``: the ring path against the reference at dp=2 x
sp=4; ``TestTensorParallel`` (the kernels' tp layout, each rank's shards
equal to the reference's ``addressable_shards`` of the same device at
dp=2 x fsdp=2 x tp=2, and 4 heads at tp=8, where a column shard cuts a
head); ``test_tp_axis_mesh_trains`` (resnet18); the GQA windowed LM on
an sp mesh; packed segments over the sp ring; the next-token shift and
the global mean under sp with packed documents, dense and fused; resnet18
at dp=2 and fsdp=2 against the one-device step on the whole batch,
``batch_stats`` included.

Tolerances (f32): logits 1e-4 absolute, the reference tests' own; the
loss 1e-5 relative; each leaf's gradient 1e-4 in relative norm; the
parameters after one AdamW step within 2 lr of the reference's (a first
step is lr * sign(g), so a gradient element near zero may take either
sign). ResNet: the loss 1e-5 relative, and every leaf of the parameters,
``batch_stats`` and the SGD trace as ``tests/test_torch_resnet.py``
holds a step (1e-4 in relative norm, a leaf's norm floored at 2^-8 of
its group's RMS).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_world
from kubeflow_tpu.models import create_train_state as jcreate_train_state
from kubeflow_tpu.models import make_train_step as jmake_train_step
from kubeflow_tpu.models import resnet18 as jresnet18
from kubeflow_tpu.models.train import make_optimizer as jmake_optimizer
from kubeflow_tpu.models.transformer import LMConfig as JLMConfig
from kubeflow_tpu.models.transformer import build_lm as jbuild_lm
from kubeflow_tpu.models.transformer import create_lm_state as jcreate_lm_state
from kubeflow_tpu.models.transformer import lm_loss as jlm_loss
from kubeflow_tpu.models.transformer import (
    make_lm_train_step as jmake_lm_train_step,
)
from kubeflow_tpu.parallel import MeshSpec as JMeshSpec
from kubeflow_tpu.parallel import make_mesh as jmake_mesh
from kubeflow_tpu.parallel.mesh import path_key
from kubeflow_tpu_torch.models import lm_loss
from kubeflow_tpu_torch.ops.cross_entropy import (
    fused_lm_loss,
    next_token_targets,
)

LR = 3e-4
LOGITS_ATOL, LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-5, 1e-4


def _np_tree(tree):
    """A (frozen) dict of arrays as a plain nested dict of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(path_key(p) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# An AdamW whose first step is a smooth function of the gradient, so that
# an update can be held (lr * g / (|g| + eps), f32 moments): eps above the
# gradients' rounding, and an lr far above the parameters' f32 spacing, as
# ``testing/torch_mesh_check.py``'s f32 check. (With the default eps a
# first step is lr * sign(g), which the 2 lr limit cannot tell from no
# step at all.) Its update is held at UPDATE_RTOL in relative norm.
F32_ADAMW = dict(lr=0.1, eps=1e-3)
UPDATE_RTOL = 1e-4


def _recording_adamw(lr=LR, eps=1e-8, mu_dtype=jnp.bfloat16):
    """The reference LM's AdamW (or one with ``lr``, ``eps`` and
    ``mu_dtype`` given), with the gradients it is given kept in the first
    entry of the chain's state."""
    record = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    return optax.chain(record, optax.adamw(lr, eps=eps, weight_decay=0.01,
                                           mu_dtype=mu_dtype))


def update_errors(got_after: dict, want_after: dict, before: dict) -> dict:
    """Each leaf's update (parameters after the step less before) against
    the reference's, in relative norm."""
    return {path: float(np.linalg.norm((got_after[path] - before[path])
                                       - (want - before[path]))
                        / np.linalg.norm(want - before[path]))
            for path, want in want_after.items()}


def packed(b, s, seed, docs=3):
    """Packed documents with boundaries off the shard grid."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, s), np.int32)
    for row in range(b):
        cuts = sorted(rng.choice(np.arange(3, s - 3), docs, replace=False))
        for i, c in enumerate(cuts):
            out[row, c:] = i + 1
    return out


# name: (mesh spec, config, batch shape, segments seed or None, step?)
LM_CASES = {
    # test_ops.py::TestTransformerLM::test_ring_path_matches_single_chip
    "ring_dp2_sp4": (dict(dp=2, sp=4), dict(vocab=128, layers=2, dim=64,
                                            heads=2), (4, 64), None, True),
    # TestTensorParallel::test_kernels_shard_over_tp, shards by device
    "tp_dp2_fsdp2_tp2": (dict(dp=2, fsdp=2, tp=2),
                         dict(vocab=128, layers=2, dim=64, heads=4), (4, 64),
                         None, True),
    # TestTensorParallel::test_tp_forward_matches_unsharded: 4 heads, tp=8
    "tp8_4heads": (dict(dp=1, tp=8), dict(vocab=128, layers=2, dim=64,
                                          heads=4), (2, 32), None, True),
    # rule leaves param_sharding leaves replicated: q/k/v/proj (36 does
    # not divide by 8) beside a sharded MLP (144 does)
    "tp8_replicated_rules": (dict(dp=1, tp=8), dict(vocab=64, layers=1,
                                                    dim=36, heads=2),
                             (2, 16), None, True),
    # test_ops.py::test_gqa_windowed_lm_trains_on_sp_mesh
    "gqa_window_sp2": (dict(dp=-1, sp=2),
                       dict(vocab=64, layers=1, dim=32, heads=4, kv_heads=2,
                            attn_window=8), (4, 32), None, True),
    # test_models.py::test_ring_path_matches_reference_with_segments
    "segments_dp4_sp2": (dict(dp=-1, sp=2), dict(vocab=64, layers=1, dim=32,
                                                 heads=2), (2, 16), "fixed",
                         False),
    # the next-token shift and the global mean under sp, packed documents
    "shift_sp4_packed": (dict(dp=2, sp=4), dict(vocab=128, layers=2, dim=64,
                                                heads=2), (4, 64), 7, True),
    "fused_sp4_packed": (dict(dp=2, sp=4),
                         dict(vocab=128, layers=2, dim=64, heads=2,
                              loss_impl="fused", ce_block=48), (4, 64), 9,
                         True),
}


def _segments(key, shape):
    if key is None:
        return None
    if key == "fixed":   # the reference test's packing
        return np.repeat([[0, 1], [0, 2]], [7, 9], axis=1).astype(np.int32)
    return packed(*shape, seed=key)


def _jax_lm_init(spec, cfg_kw, seq, adamw=None):
    """The reference's mesh, model and state (its own init on its mesh),
    with the parameters as numpy and each leaf's shard on each device.
    ``adamw``: the optimizer's ``lr`` and ``eps`` with f32 moments
    (:data:`F32_ADAMW`), else the reference LM's."""
    mesh = jmake_mesh(JMeshSpec(**spec))
    cfg = JLMConfig(**cfg_kw)
    model = jbuild_lm(cfg, mesh=mesh)
    tx = (_recording_adamw() if adamw is None
          else _recording_adamw(mu_dtype=None, **adamw))
    state = jcreate_lm_state(model, jax.random.key(0), (2, seq), tx=tx,
                             mesh=mesh)
    shards = {path: {s.device.id: np.asarray(s.data)
                     for s in leaf.addressable_shards}
              for path, leaf in _flat_arrays(state.params).items()}
    return (mesh, cfg, model, state), _np_tree(state.params), shards


def _jax_lm_refs(mesh, cfg, model, state, tokens, seg, step):
    """Its logits, and with ``step`` one train step: the loss, the
    gradients (recorded) and the parameters after it."""
    seg_j = None if seg is None else jnp.asarray(seg)
    apply = jax.jit(lambda p, t, s: model.apply({"params": p}, t, s))
    out = {"logits": np.asarray(apply(state.params, jnp.asarray(tokens),
                                      seg_j))}
    if step:
        batch = {"tokens": jnp.asarray(tokens)}
        if seg is not None:
            batch["segment_ids"] = seg_j
        new, metrics = jmake_lm_train_step(mesh, cfg=cfg)(state, batch)
        out.update(loss=float(metrics["loss"]),
                   grads=_flat(new.opt_state[0]), after=_flat(new.params))
    return out


def _flat_arrays(tree):
    return {"/".join(path_key(p) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------ ResNet


def _jax_resnet18():
    return jresnet18(num_classes=8, width=8, dtype=jnp.float32)


def _resnet_variables(seed):
    """The reference resnet18's init (width 8, 8 classes), every
    BatchNorm scale moved by N(0, 0.2) so the residual branches count."""
    state = jcreate_train_state(_jax_resnet18(), jax.random.key(seed),
                                (2, 32, 32, 3))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.array(a)
        if path_key(path[-1]) == "scale":
            a = a + rng.normal(size=a.shape).astype(np.float32) * 0.2
        return a

    params = jax.tree_util.tree_map_with_path(perturb, state.params)
    return state.replace(params=params)


def _resnet_np(state):
    return {"params": _np_tree(state.params),
            "batch_stats": _np_tree(state.batch_stats),
            "trace": _np_tree(state.opt_state[1][0].trace)}


def _jax_resnet(state, images, labels, spec=None):
    """One reference step: on a mesh (``spec``) or on one device."""
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    if spec is None:
        new, metrics = jmake_train_step()(state, batch)
    else:
        mesh = jmake_mesh(JMeshSpec(**spec))
        placed = jcreate_train_state(_jax_resnet18(), jax.random.key(0),
                                     (2, 32, 32, 3), tx=jmake_optimizer(),
                                     mesh=mesh)

        def put(dst, src):
            return jax.tree.map(
                lambda d, a: jax.device_put(np.asarray(a), d.sharding),
                dst, src)

        placed = placed.replace(
            params=put(placed.params, state.params),
            batch_stats=put(placed.batch_stats, state.batch_stats),
            opt_state=put(placed.opt_state, state.opt_state))
        new, metrics = jmake_train_step(mesh)(placed, batch)
    return {"loss": float(metrics["loss"]),
            "accuracy": float(metrics["accuracy"]),
            "params": _flat(new.params),
            "batch_stats": _flat(new.batch_stats),
            "trace": _flat(new.opt_state[1][0].trace)}


def _image_batch(seed, n=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 8, size=(n,)))


# ------------------------------------------------------------- worlds


@pytest.fixture(scope="module")
def lm_world(tmp_path_factory):
    """The reference inits first; the world runs while the reference
    computes its logits and steps."""
    tasks, pending, refs = [], {}, {}
    for name, (spec, cfg, shape, seg_key, step) in LM_CASES.items():
        rng = np.random.default_rng(len(name))
        tokens = rng.integers(0, cfg["vocab"], size=shape)
        seg = _segments(seg_key, shape)
        jax_state, params, shards = _jax_lm_init(spec, cfg, shape[1])
        pending[name] = (jax_state, tokens, seg, step)
        refs[name] = {"shards": shards}
        tasks.append((f"lm:{name}", dict(
            spec=spec, cfg=cfg, params=params, tokens=tokens,
            segment_ids=seg, forward_tokens=tokens, forward_segment_ids=seg,
            step=step)))
    jstate = _resnet_variables(3)
    images, labels = _image_batch(3)
    spec = dict(dp=2, fsdp=2, tp=2)
    tasks.append(("resnet:tp", dict(spec=spec, variables=_resnet_np(jstate),
                                    images=images, labels=labels)))
    tasks.append(("resnet:fsdp4", dict(
        spec=dict(dp=2, fsdp=4), variables=_resnet_np(jstate), images=images,
        labels=labels, meshless=True)))
    tasks.append(("mesh_api", {}))
    world = torch_world.World(8, tasks, tmp_path_factory.mktemp("lm_world"))
    for name, (jax_state, tokens, seg, step) in pending.items():
        refs[name].update(_jax_lm_refs(*jax_state, tokens, seg, step))
    refs["resnet_tp"] = _jax_resnet(jstate, images, labels, spec)
    refs["resnet_whole"] = _jax_resnet(jstate, images, labels)
    return world.wait(), refs


@pytest.fixture(scope="module")
def pair_world(tmp_path_factory):
    """Two ranks from ``initialize_from_env``: resnet18 at dp=2 and at
    fsdp=2 beside the port's and the reference's one-device steps."""
    jstate = _resnet_variables(4)
    images, labels = _image_batch(4)
    variables = _resnet_np(jstate)
    tasks = [("world", {}), ("mesh_api", {})] + [
        (f"resnet:{name}", dict(spec=spec, variables=variables,
                                images=images, labels=labels, meshless=True))
        for name, spec in (("dp2", dict(dp=2)), ("fsdp2", dict(dp=1, fsdp=2)))]
    tasks += [(f"batch_norm:{name}", dict(spec=spec, **inputs))
              for name, spec in (("dp2", dict(dp=2)),
                                 ("fsdp2", dict(dp=1, fsdp=2)))
              for inputs in [_bn_world_inputs()]]
    world = torch_world.World(2, tasks, tmp_path_factory.mktemp("pair"))
    want = _jax_resnet(jstate, images, labels)
    return world.wait(), want


def _logits(results, name, batch_rows):
    """The whole (rows, S, vocab) output from every rank's sp columns,
    and every rank that holds the same columns equal."""
    cols = {}
    for out in torch_world.outputs(results, f"lm:{name}"):
        if out["cols"] in cols:
            np.testing.assert_allclose(out["logits"], cols[out["cols"]],
                                       atol=1e-6, rtol=0)
        cols.setdefault(out["cols"], out["logits"])
    whole = np.concatenate([cols[c] for c in sorted(cols)], axis=1)
    assert whole.shape[0] == batch_rows
    return whole


# ------------------------------------------------------------- LM cases


@pytest.mark.parametrize("name", sorted(LM_CASES))
def test_mesh_forward_matches_the_reference(lm_world, name):
    results, refs = lm_world
    got = _logits(results, name, LM_CASES[name][2][0])
    np.testing.assert_allclose(got, refs[name]["logits"], atol=LOGITS_ATOL,
                               rtol=0)


STEP_CASES = sorted(n for n, case in LM_CASES.items() if case[4])


@pytest.mark.parametrize("name", STEP_CASES)
def test_mesh_step_loss_matches_the_reference(lm_world, name):
    results, refs = lm_world
    losses = {out["loss"] for out in torch_world.outputs(results,
                                                         f"lm:{name}")}
    assert len(losses) == 1, losses   # every rank reports the global mean
    loss = losses.pop()
    want = refs[name]["loss"]
    assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)


@pytest.mark.parametrize("name", STEP_CASES)
def test_mesh_step_gradients_match_the_reference(lm_world, name):
    """Every leaf, the tp-replicated ones (norm scales, the embedding)
    included: summed over the axes that split the data, never over tp."""
    results, refs = lm_world
    got = torch_world.outputs(results, f"lm:{name}")[0]["grads"]
    want = refs[name]["grads"]
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        err = np.linalg.norm(g - want[path]) / np.linalg.norm(want[path])
        assert err <= GRAD_RTOL, (path, err)


@pytest.mark.parametrize("name", STEP_CASES)
def test_mesh_step_parameters_match_the_reference(lm_world, name):
    results, refs = lm_world
    for out in torch_world.outputs(results, f"lm:{name}"):
        got = out["params"]
        for path, want in refs[name]["after"].items():
            assert np.abs(got[path] - want).max() <= 2 * LR, path


def test_tp_layout_shards_each_rank_like_the_reference_device(lm_world):
    """dp=2 x fsdp=2 x tp=2: q/k/v/up column-parallel, proj/down
    row-parallel, fsdp on the other dim; rank r's shard of every leaf
    has the shape and the values of the reference's shard on device r."""
    results, refs = lm_world
    shards = refs["tp_dp2_fsdp2_tp2"]["shards"]
    for out in torch_world.outputs(results, "lm:tp_dp2_fsdp2_tp2"):
        assert sorted(out["shards"]) == sorted(shards)
        for path, local in out["shards"].items():
            want = shards[path][out["rank"]]
            assert local.shape == want.shape, path
            np.testing.assert_array_equal(local, want, err_msg=path)
    q = shards["block_0/q_proj/kernel"][0]
    down = shards["block_0/down/kernel"][0]
    assert q.shape == (32, 32) and down.shape == (128, 32)


def test_resnet_on_a_dp_fsdp_tp_mesh_matches_the_reference(lm_world):
    """test_tp_axis_mesh_trains: resnet18 at dp=2 x fsdp=2 x tp=2 (tp
    replicates an image model's leaves) against the reference's step on
    its mesh."""
    results, refs = lm_world
    for out in torch_world.outputs(results, "resnet:tp"):
        _check_resnet(out["mesh"], refs["resnet_tp"])


def test_mesh_axes_auto_mesh_batch_rows_and_multislice(lm_world):
    """``tests/test_parallel.py``'s world cases: the axes and shape of
    dp=2 x fsdp=2 x tp=2, ``auto_mesh`` all dp, a (16, 3) batch's block
    under ``batch_sharding`` at dp=4 x fsdp=2, and the multislice mesh
    (dp=4 x fsdp=2 over 2 slices: rank r at dp r // 2)."""
    results, _ = lm_world
    for rank, out in enumerate(torch_world.outputs(results, "mesh_api")):
        assert out["axis_names"] == ("dp", "pp", "fsdp", "tp", "sp", "ep")
        assert out["shape"] == {"dp": 2, "pp": 1, "fsdp": 2, "tp": 2,
                                "sp": 1, "ep": 1}
        assert out["auto_dp"] == 8
        assert out["batch_block"] == (2, 3)
        shape, coords = out["multislice"]
        assert shape["dp"] == 4 and shape["fsdp"] == 2
        assert (coords["dp"], coords["fsdp"]) == (rank // 2, rank % 2)


def test_refactored_spec_builds_a_working_mesh(pair_world):
    results, _ = pair_world
    for out in torch_world.outputs(results, "mesh_api"):
        assert out["auto_dp"] == 2
        assert out["refactored"] == {"dp": 1, "pp": 1, "fsdp": 1, "tp": 2,
                                     "sp": 1, "ep": 1}


# ---------------------------------------------------------- ResNet cases


def _group_errors(got, want):
    """Per group: the worst leaf's relative norm, a leaf's norm floored
    at 2^-8 x the group's RMS x sqrt(leaf size)."""
    rms = np.sqrt(sum(np.sum(w ** 2) for w in want.values())
                  / sum(w.size for w in want.values()))
    return max((float(np.linalg.norm((got[k] - w).ravel())
                      / max(np.linalg.norm(w.ravel()),
                            2.0 ** -8 * rms * np.sqrt(w.size))), k)
               for k, w in want.items())


def _check_resnet(got, want):
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert got["accuracy"] == want["accuracy"]
    for group in ("params", "batch_stats", "trace"):
        assert sorted(got[group]) == sorted(want[group])
        err, key = _group_errors(got[group], want[group])
        assert err <= 1e-4, (group, key, err)


@pytest.mark.parametrize("name", ["dp2", "fsdp2"])
def test_resnet_split_batch_equals_the_one_device_step(pair_world, name):
    """A sharded flax BatchNorm takes the whole batch's moments: the
    dp=2 (fsdp=2) step equals the reference's one-device step on the
    whole batch, ``batch_stats`` included, and the port's own."""
    results, want = pair_world
    for out in torch_world.outputs(results, f"resnet:{name}"):
        _check_resnet(out["mesh"], want)
        _check_resnet(out["mesh"], out["meshless"])
        err, key = _group_errors(out["mesh"]["grads"],
                                 out["meshless"]["grads"])
        assert err <= GRAD_RTOL, (key, err)


def test_resnet_fsdp4_step_equals_the_one_device_step(lm_world):
    """resnet18 at dp=2 x fsdp=4 (one image a rank), its weights gathered
    a block at a time, against the reference's and the port's one-device
    steps on the whole batch."""
    results, refs = lm_world
    for out in torch_world.outputs(results, "resnet:fsdp4"):
        _check_resnet(out["mesh"], refs["resnet_whole"])
        _check_resnet(out["mesh"], out["meshless"])
        err, key = _group_errors(out["mesh"]["grads"],
                                 out["meshless"]["grads"])
        assert err <= GRAD_RTOL, (key, err)


def _fsdp_leaves_by_piece(placements: dict) -> dict[str, int]:
    """The fsdp-sharded leaves of each piece ResNet gathers at once: the
    stem (``conv_init``, ``norm_init``), each block, the head."""
    pieces: dict[str, int] = {}
    for path, placement in placements.items():
        top = path.split("/")[0]
        piece = "stem" if top in ("conv_init", "norm_init") else top
        pieces[piece] = pieces.get(piece, 0) + ("fsdp" in placement)
    return pieces


@pytest.mark.parametrize("name", ["fsdp2", "fsdp4"])
def test_resnet_fsdp_holds_one_block_whole_at_a_time(lm_world, pair_world,
                                                     name):
    """At every gather of the step, the whole weights alive are at most
    one piece's fsdp leaves (the stem, a block or the head), fewer than
    all of them, and each piece's leaves were gathered again in its
    backward (more gathers than leaves)."""
    results = (pair_world if name == "fsdp2" else lm_world)[0]
    for out in torch_world.outputs(results, f"resnet:{name}"):
        pieces = _fsdp_leaves_by_piece(out["placements"])
        total = sum(pieces.values())
        assert 0 < max(pieces.values()) < total, pieces
        assert 0 < out["whole_peak"] <= max(pieces.values()), (
            out["whole_peak"], pieces)
        assert out["gathers"] > total


def _bn_world_inputs(seed=4):
    """A whole batch (8, 20, 5, 3) f32 for the BatchNorm group case:
    x, the output's gradient, scale, bias and a residual (the block's
    last norm: residual sum and ReLU)."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(x=f32(8, 20, 5, 3, scale=2.0) + 0.5, g=f32(8, 20, 5, 3),
                scale=f32(20), bias=f32(20), residual=f32(8, 20, 5, 3))


@pytest.mark.parametrize("name", ["dp2", "fsdp2"])
def test_batch_norm_group_moments_equal_the_whole_batch(pair_world, name):
    """A BatchNorm whose moments and backward sums are all-reduced over
    two gloo ranks gives each rank its rows of the one-process BatchNorm
    of the whole batch: the output, the running averages, dx and the
    residual's gradient, and the scale and bias gradients summed over
    the ranks, to f32 summation order (1e-5 of each tensor's largest
    element)."""
    from kubeflow_tpu_torch.ops.batch_norm import batch_norm_train

    results, _ = pair_world
    inputs = _bn_world_inputs()
    leaves = [torch.from_numpy(inputs[k]).requires_grad_()
              for k in ("x", "scale", "bias", "residual")]
    c = inputs["x"].shape[1]
    out, mean, var = batch_norm_train(leaves[0], leaves[1], leaves[2],
                                      torch.zeros(c), torch.ones(c),
                                      relu=True, residual=leaves[3])
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(inputs["g"]))
    want = {"out": out, "mean": mean, "var": var,
            **dict(zip(("dx", "dscale", "dbias", "dres"), grads))}
    want = {k: v.detach().numpy() for k, v in want.items()}
    ranks = torch_world.outputs(results, f"batch_norm:{name}")

    def close(got, ref):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())

    for key in ("out", "dx", "dres"):
        close(np.concatenate([r[key] for r in sorted(
            ranks, key=lambda r: r["rows"])]), want[key])
    for key in ("mean", "var"):
        for r in ranks:
            close(r[key], want[key])
    for key in ("dscale", "dbias"):
        close(sum(r[key] for r in ranks), want[key])


def test_initialize_from_env_forms_the_world(pair_world):
    results, _ = pair_world
    assert torch_world.outputs(results, "world") == [
        {"rank": r, "world": 2, "backend": "gloo", "process_id": r,
         "num_processes": 2} for r in range(2)]


# ------------------------------------------- the loss across sp shards


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("shards", [2, 4])
def test_shard_losses_sum_to_the_global_mean(fused, shards):
    """Each sequence shard predicts across its last position into the
    next shard (``next_token_targets`` of the whole batch), and its loss
    is its NLL sum over the whole batch's count: the shards' losses sum
    to the reference's mean on packed documents whose counts differ by
    shard, where a mean of the shards' means does not."""
    rng = np.random.default_rng(shards)
    b, s, d, vocab = 3, 32, 16, 40
    tokens = rng.integers(0, vocab, size=(b, s))
    seg = packed(b, s, seed=shards + 10)
    hidden = rng.normal(size=(b, s, d)).astype(np.float32)
    emb = rng.normal(size=(vocab, d)).astype(np.float32)
    logits = hidden @ emb.T
    want = float(jlm_loss(jnp.asarray(logits), jnp.asarray(tokens),
                          jnp.asarray(seg)))
    t_tokens, t_seg = torch.from_numpy(tokens), torch.from_numpy(seg)
    targets, valid = next_token_targets(t_tokens, t_seg)
    count = valid.sum()
    parts, means = [], []
    for i in range(shards):
        cols = slice(i * s // shards, (i + 1) * s // shards)
        shard = dict(targets=targets[:, cols], valid=valid[:, cols])
        if fused:
            def loss(**kw):
                return fused_lm_loss(torch.from_numpy(hidden[:, cols]),
                                     torch.from_numpy(emb), None, block=16,
                                     **shard, **kw)
        else:
            def loss(**kw):
                return lm_loss(torch.from_numpy(logits[:, cols]), None,
                               **shard, **kw)
        parts.append(float(loss(count=count)))
        means.append(float(loss()))
    assert abs(sum(parts) - want) <= 1e-5 * abs(want)
    assert abs(np.mean(means) - want) > 1e-3 * abs(want)

"""CPU parity of the port's ResNet (``kubeflow_tpu_torch/models/resnet.py``),
its Nesterov SGD (``models/optim.py`` ``make_optimizer``) and its image
train and eval steps (``models/train.py``) against the JAX package.

The cases follow ``tests/test_models.py``: a resnet18 of width 8 on
32x32 images, its forward, train step and eval step, and ResNet-50's
forward. Weights come from the reference's own init, carried across with
``resnet_variables_from_jax``/``train_state_from_jax``; every
zero-initialised BatchNorm scale (the last norm of each residual branch)
is perturbed from a numpy seed first, or the comparison would never
exercise the residual branches. Tolerances, each with its reason:

- f32 forward (train and eval mode): logits and the new ``batch_stats``
  to 1e-4 of each tensor's largest element: the same arithmetic summed
  in another order (measured: 5e-7).
- f32, 3 train steps from a carried state against the jitted JAX step:
  losses to 5e-5 (measured: 9.1e-6 at most over 6 seeds), and every
  leaf of params, ``batch_stats`` and the SGD trace to 1e-4 in relative
  norm, a leaf's norm floored at 2^-8 of its group's RMS times the
  square root of its size (measured: 3.4e-5 at most over 6 seeds). The
  floor is the kernel checks' row floor: in the last stage a BatchNorm
  sees 8 values per channel (1x1 maps, batch 8) and its fast variance
  cancels, so a leaf whose gradient nearly cancels differs in relative
  terms between any two summation orders; the JAX package's own jitted
  and eager steps differ by up to 2.4e-2 on such a leaf (measured).
- bf16 forward against eager flax (op by op, the same rounding points):
  logits to 5e-2 of their largest element, ``batch_stats`` to 5e-3: one
  bf16 rounding that lands the other way in a convolution (summation
  order) moves what follows it through the BatchNorms (measured: equal
  to 5e-7 for most inputs, 1.8e-2 of the logits for one).
- bf16, one train step against the eager JAX step: the loss to 2e-2,
  ``batch_stats`` to 1e-3, the parameters to 2e-2 and the trace (the
  step's gradient) to 0.3 in their group's relative norm (measured over
  10 seeds: 6.1e-3, 1.6e-4, 8.0e-3 and 0.148 at most; the trace at
  0.008-0.011 where no forward rounding landed the other way): the
  forward's flips above, and the BatchNorm backward, which runs in f32
  and rounds once here where JAX's autodiff rounds its partial sums to
  bf16, while ``g - mean(g) - xhat * mean(g * xhat)`` cancels.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from kubeflow_tpu.models import checkpoint as jckpt
from kubeflow_tpu.models import create_train_state as jcreate_train_state
from kubeflow_tpu.models import make_eval_step as jmake_eval_step
from kubeflow_tpu.models import make_train_step as jmake_train_step
from kubeflow_tpu.models import resnet18 as jresnet18
from kubeflow_tpu.models import resnet50 as jresnet50
from kubeflow_tpu.models.train import cross_entropy as jcross_entropy
from kubeflow_tpu.models.train import make_optimizer as jmake_optimizer
from kubeflow_tpu_torch.models import (
    create_train_state,
    cross_entropy,
    make_eval_step,
    make_optimizer,
    make_train_step,
    resnet18,
    resnet50,
    resnet_flops_per_image,
    resnet_variables_from_jax,
    train_state_from_jax,
)
from kubeflow_tpu_torch.models.checkpoint import _arrays_only, _flatten_keys
from kubeflow_tpu_torch.models.optim import flatten
from kubeflow_tpu_torch.models.resnet import conv, max_pool, same_pads
from kubeflow_tpu_torch.parallel import Mesh, MeshSpec

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _batch(rng, batch=8, size=32, classes=8):
    return (rng.normal(size=(batch, size, size, 3)).astype(np.float32),
            rng.integers(0, classes, size=(batch,)))


def _perturbed(tree, rng, stats=False):
    """BatchNorm scales (the zero-initialised ones included) moved by
    N(0, 0.2); with ``stats`` also biases and the running averages."""
    def leaf(path, a):
        key = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "scale" in key or (stats and a.ndim == 1 and "head" not in key):
            a = a + rng.normal(size=a.shape).astype(np.float32) * 0.2
        if stats and "var" in key:
            a = np.abs(a) + 0.5
        return a
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _jax_state(dtype, seed, size=32, perturb=True):
    model = jresnet18(num_classes=8, width=8, dtype=dtype)
    state = jcreate_train_state(model, jax.random.key(seed),
                                (2, size, size, 3))
    if perturb:
        state = state.replace(params=_perturbed(
            state.params, np.random.default_rng(seed)))
    return state


def _leaves(tree_or_state, port: bool) -> dict[str, np.ndarray]:
    """keystr -> f32 numpy copy, of a port state or a JAX state."""
    if port:
        pairs = _flatten_keys(_arrays_only(tree_or_state))
    else:
        pairs = jckpt._flatten_keys(jckpt._arrays_only(tree_or_state))
    out = {}
    for key, leaf in pairs:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().float().numpy()
        out[key] = np.array(leaf, dtype=np.float32)
    return out


def _group_errors(got, want):
    """Per group (params, batch_stats, opt_state): the group's relative
    norm, and the worst leaf's relative norm with the leaf's norm
    floored at 2^-8 x the group's RMS x sqrt(leaf size)."""
    out = {}
    for group in ("['params']", "['batch_stats']", "['opt_state']"):
        keys = [k for k in want if k.startswith(group)]
        num = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in keys))
        den = np.sqrt(sum(np.sum(want[k] ** 2) for k in keys))
        rms = den / np.sqrt(sum(want[k].size for k in keys))
        worst = max(
            (float(np.linalg.norm((got[k] - want[k]).ravel())
                   / max(np.linalg.norm(want[k].ravel()),
                         2.0 ** -8 * rms * np.sqrt(want[k].size))), k)
            for k in keys)
        out[group] = (float(num / den), worst)
    return out


# ------------------------------------------------------------ layers


@pytest.mark.parametrize("size", [7, 8, 15, 32, 33])
@pytest.mark.parametrize("kernel,stride", [(7, 2), (3, 2), (3, 1), (1, 2),
                                           (1, 1)])
def test_same_padding_matches_lax(size, kernel, stride):
    """SAME pads total // 2 before and the rest after, at odd and even
    sizes; the max pool pads with -inf."""
    rng = np.random.default_rng(size * 100 + kernel * 10 + stride)
    x = rng.normal(size=(2, size, size + 1, 3)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w),
               stride, torch.float32).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    pooled = max_pool(torch.from_numpy(-np.abs(x)).permute(0, 3, 1, 2))
    want = nn.max_pool(jnp.asarray(-np.abs(x)), (3, 3), strides=(2, 2),
                       padding="SAME")
    np.testing.assert_array_equal(pooled.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_same_pads_of_the_stem_and_the_stride_two_layers():
    assert same_pads(224, 7, 2) == (2, 3)
    assert same_pads(112, 3, 2) == (0, 1)
    assert same_pads(56, 3, 2) == (0, 1)
    assert same_pads(56, 1, 2) == (0, 0)
    assert same_pads(56, 3, 1) == (1, 1)
    assert same_pads(7, 3, 2) == (1, 1)


# ------------------------------------------------------------ forward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_matches_flax(dtype, train):
    jdt, tdt = DTYPES[dtype]
    model = jresnet18(num_classes=8, width=8, dtype=jdt)
    rng = np.random.default_rng(3)
    variables = _perturbed(
        model.init(jax.random.key(0), jnp.zeros((2, 32, 32, 3)),
                   train=False), rng, stats=True)
    x, _ = _batch(rng, batch=4)
    port = resnet18(num_classes=8, width=8, dtype=tdt)
    tv = resnet_variables_from_jax(variables, device="cpu")
    if train:
        want, updates = model.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
        got, stats = port(tv["params"], tv["batch_stats"],
                          torch.from_numpy(x), train=True)
        want_stats = jax.tree.map(np.asarray, updates["batch_stats"])
        assert sorted(k for k, _ in flatten(stats)) == sorted(
            k for k, _ in flatten(want_stats))
        tol = 1e-4 if dtype == "float32" else 5e-3
        for (path, s), (_, w) in zip(flatten(stats), flatten(want_stats)):
            np.testing.assert_allclose(s.numpy(), w, rtol=0,
                                       atol=tol * np.abs(w).max(),
                                       err_msg=path)
    else:
        want = model.apply(variables, jnp.asarray(x), train=False)
        got = port(tv["params"], tv["batch_stats"], torch.from_numpy(x),
                   train=False)
    assert got.dtype == torch.float32 and got.shape == (4, 8)
    want = np.asarray(want)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_init_has_the_reference_names_layouts_and_scales(name):
    """The same variable tree (names, shapes) as flax's init; the last
    norm of each residual branch zero-scaled; conv kernels of std
    sqrt(2 / fan_out) and the head of std sqrt(1 / fan_in), as the
    reference's initialisers draw them."""
    jmodel = {"resnet18": jresnet18, "resnet50": jresnet50}[name](
        num_classes=10)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    want = {k: tuple(v.shape) for k, v in flatten(dict(shapes))}
    port = {"resnet18": resnet18, "resnet50": resnet50}[name](num_classes=10)
    variables = port.init_variables(seed=0, device="cpu")
    got = {k: tuple(v.shape) for k, v in flatten(variables)}
    assert got == want
    last = "BatchNorm_2" if name == "resnet50" else "BatchNorm_1"
    for block, p in variables["params"].items():
        if block.endswith(tuple("0123456789")):
            assert not p[last]["scale"].any(), block
            assert p["BatchNorm_0"]["scale"].eq(1).all(), block
    kernel = variables["params"]["BasicBlock_0" if name == "resnet18"
                                 else "BottleneckBlock_0"]["Conv_1"]["kernel"]
    fan_out = kernel.shape[0] * kernel.shape[1] * kernel.shape[3]
    assert abs(float(kernel.std()) / (2 / fan_out) ** 0.5 - 1) < 0.05
    head = variables["params"]["head"]["kernel"]
    assert abs(float(head.std()) / head.shape[0] ** -0.5 - 1) < 0.1
    assert float(head.abs().max()) <= 2 * head.shape[0] ** -0.5 / 0.8796


def test_resnet50_forward_matches_flax():
    """ResNet-50 at full width on 32x32 images: logits (f32) and shape,
    the reference's ``test_resnet50_forward_shape`` held to values."""
    model = jresnet50(num_classes=10, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    variables = _perturbed(model.init(jax.random.key(0), jnp.asarray(x),
                                      train=False), rng)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    tv = resnet_variables_from_jax(variables, device="cpu")
    got = resnet50(num_classes=10, dtype=torch.float32)(
        tv["params"], tv["batch_stats"], torch.from_numpy(x), train=False)
    assert got.shape == (2, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_flops_estimate():
    assert resnet_flops_per_image("resnet50") == pytest.approx(8.18e9,
                                                              rel=0.01)
    assert resnet_flops_per_image("resnet18", 112) == pytest.approx(
        1.81e9 * 2 / 4)


# ------------------------------------------------------------ optimizer


def test_sgd_matches_optax_with_masked_decay_and_nesterov():
    """Three updates of ``make_optimizer`` against optax's chain on the
    same params and gradients: decay on leaves of ndim > 1 only; the
    state keeps optax's tree."""
    rng = np.random.default_rng(7)
    params = {"conv": {"kernel": rng.normal(size=(3, 3, 4, 8))},
              "norm": {"scale": rng.normal(size=(8,)),
                       "bias": rng.normal(size=(8,))},
              "head": {"kernel": rng.normal(size=(8, 5)),
                       "bias": rng.normal(size=(5,))}}
    params = jax.tree.map(lambda a: a.astype(np.float32), params)
    tx = jmake_optimizer(lr=0.05, weight_decay=1e-3)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    port = make_optimizer(lr=0.05, weight_decay=1e-3)
    tparams = {k: {n: torch.from_numpy(np.array(a)) for n, a in v.items()}
               for k, v in params.items()}
    tstate = port.init(tparams)
    for _ in range(3):
        grads = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        with torch.no_grad():
            port.update([torch.from_numpy(g) for _, g in flatten(grads)],
                        tstate, tparams)
    for (path, p), (_, w) in zip(flatten(tparams),
                                 flatten(jax.tree.map(np.asarray, jparams))):
        np.testing.assert_allclose(p.numpy(), w, rtol=1e-6, atol=1e-7,
                                   err_msg=path)
    want = {k: np.asarray(v) for k, v in
            jckpt._flatten_keys({"opt_state": jstate})}
    got = {k: v.numpy() for k, v in
           _flatten_keys({"opt_state": tstate})}
    assert sorted(got) == sorted(want) and all(
        "trace" in k for k in got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   atol=1e-7, err_msg=key)


def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(6, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 6)
    for smoothing in (0.0, 0.1):
        np.testing.assert_allclose(
            float(cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), smoothing)),
            float(jcross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 smoothing)), rtol=1e-6)


# ------------------------------------------------------------ steps


@pytest.mark.parametrize("seed", [0, 1])
def test_train_steps_match_jax_from_a_carried_state(seed):
    jstate = _jax_state(jnp.float32, seed)
    tstate = train_state_from_jax(resnet18(num_classes=8, width=8,
                                           dtype=torch.float32),
                                  jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    assert tstate.step == 0
    jstep, tstep = jmake_train_step(), make_train_step()
    rng = np.random.default_rng(seed)
    for _ in range(3):
        x, y = _batch(rng)
        jstate, jm = jstep(jstate, {"image": jnp.asarray(x),
                                    "label": jnp.asarray(y)})
        tstate, tm = tstep(tstate, {"image": torch.from_numpy(x),
                                    "label": torch.from_numpy(y)})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 5e-5
        assert float(tm["accuracy"]) == float(jm["accuracy"])
    assert tstate.step == int(jstate.step) == 3
    got, want = _leaves(tstate, port=True), _leaves(jstate, port=False)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("['opt_state'][1][0].trace") for k in got)
    for group, (total, (worst, key)) in _group_errors(got, want).items():
        assert total <= 1e-4, (group, total)
        assert worst <= 1e-4, (key, worst)


def test_bf16_train_step_matches_eager_jax():
    jstate = _jax_state(jnp.bfloat16, 0)
    tstate = train_state_from_jax(resnet18(num_classes=8, width=8,
                                           dtype=torch.bfloat16),
                                  jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    rng = np.random.default_rng(0)
    x, y = _batch(rng)
    with jax.disable_jit():   # op by op: bf16 rounds where the port's does
        jstate, jm = jmake_train_step()(jstate, {"image": jnp.asarray(x),
                                                 "label": jnp.asarray(y)})
    tstate, tm = make_train_step()(tstate, {"image": torch.from_numpy(x),
                                            "label": torch.from_numpy(y)})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2e-2
    errors = _group_errors(_leaves(tstate, port=True),
                           _leaves(jstate, port=False))
    assert errors["['batch_stats']"][0] <= 1e-3, errors
    assert errors["['params']"][0] <= 2e-2, errors
    assert errors["['opt_state']"][0] <= 0.3, errors


def test_eval_step_matches_jax_and_uses_the_running_averages():
    jstate = _jax_state(jnp.float32, 2)
    jstate, _ = jmake_train_step()(jstate, {
        "image": jnp.asarray(_batch(np.random.default_rng(4))[0]),
        "label": jnp.zeros(8, jnp.int32)})
    tstate = train_state_from_jax(resnet18(num_classes=8, width=8,
                                           dtype=torch.float32),
                                  jax.tree.map(np.asarray, jstate),
                                  device="cpu")
    x, y = _batch(np.random.default_rng(5))
    want = jmake_eval_step()(jstate, {"image": jnp.asarray(x),
                                      "label": jnp.asarray(y)})
    before = _leaves(tstate, port=True)
    got = make_eval_step()(tstate, {"image": torch.from_numpy(x),
                                    "label": torch.from_numpy(y)})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    assert float(got["accuracy"]) == float(want["accuracy"])
    after = _leaves(tstate, port=True)
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_port_step_descends_and_moves_the_batch_stats():
    """The reference's overfit check on the port alone: six steps on one
    batch lower the loss; each step replaces ``batch_stats``."""
    state = create_train_state(resnet18(num_classes=4, width=8,
                                        dtype=torch.float32), seed=1,
                               input_shape=(2, 32, 32, 3),
                               tx=make_optimizer(lr=0.05), device="cpu")
    assert state.opt_state[1][0].trace["head"]["kernel"].shape == (64, 4)
    step = make_train_step(smoothing=0.0)
    x, y = _batch(np.random.default_rng(6), batch=16, classes=4)
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}
    first = state.batch_stats["norm_init"]["mean"].clone()
    losses = []
    for _ in range(6):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert state.step == 6 and losses[-1] < losses[0]
    assert not torch.equal(state.batch_stats["norm_init"]["mean"], first)
    assert all(p.grad is None for _, p in flatten(state.params))


def test_meshes_name_a10():
    """Image training on dp/fsdp/tp/sp meshes is ported (tests/
    test_torch_mesh_train.py), and on ep since A10c: an image model has
    no expert stacks, so ep replicates every leaf (rank 1 of an ep=2
    mesh holds the whole state). Since A10b pp is inert on the image
    step, as the reference's (tests/test_torch_pipeline_ckpt.py runs it
    on dp2 x pp2 x fsdp2): rank 1 of a pp=2 mesh holds the whole state
    too."""
    model = resnet18(num_classes=4, width=8)
    pp = Mesh(MeshSpec(dp=1, pp=2).resolve(2), torch.device("cpu"), {}, 1)
    on_pp = create_train_state(model, 0, (1, 32, 32, 3), mesh=pp,
                               device="cpu")
    assert all(placement == () for placement in
               on_pp.placements["params"].values())
    mesh = Mesh(MeshSpec(dp=1, ep=2).resolve(2), torch.device("cpu"), {}, 1)
    state = create_train_state(model, 0, (1, 32, 32, 3), mesh=mesh,
                               device="cpu")
    whole = create_train_state(model, 0, (1, 32, 32, 3), device="cpu")
    assert state.mesh is mesh
    assert all(p == () for group in state.placements.values()
               for p in group.values())
    for (path, got), (_, want) in zip(flatten(state.params),
                                      flatten(whole.params)):
        assert torch.equal(got, want), path

"""Pipeline-parallel transformer LM over the ``pp`` mesh axis.

The counterpart of ``kubeflow_tpu/models/pipeline_lm.py``:
:class:`PipelinedLM` (its validations, ``init``, ``apply`` and
``sequential_apply``), :func:`pp_param_sharding`,
:func:`create_pp_lm_state` and :func:`make_pp_lm_train_step`.

The homogeneous-middle layout: the embedding and the tied head run
outside the pipeline (replicated over pp), while the block stack, where
the depth lives, is stacked on a leading layer dim, split into ``pp``
contiguous stages and driven by a schedule of ``parallel.pipeline``.
Parameters keep the reference's layout, ``{"embed", "blocks",
"final_norm"}``, every ``blocks`` leaf depth-stacked ``(layers, ...)``;
a rank holds its stage's ``(layers/P, ...)`` slice. The blocks are the
port's :class:`~kubeflow_tpu_torch.models.transformer.Block` with its
:class:`~kubeflow_tpu_torch.models.transformer.TensorParallel`, the
attention core of ``build_lm`` (the flash kernels on CUDA tensors,
ring attention over sp on a pp x sp mesh, RoPE at the shard's global
offset) and fsdp's per-block gathers (``parallel.fsdp.gathered_call``).

Replicated leaves and the loss. ``embed`` and ``final_norm`` are
replicated over pp. The engines return the lookup's input cotangent
whole on every rank; with ``output="sharded"`` (M divisible by P) each
stage runs the norm and the head on its M / P microbatches, so both
leaves enter the head through ``CopyToGroup`` over pp (their gradient
all-reduced over pp in the backward), and each rank's loss is its
microbatches' share of the whole batch's mean; with ``"replicated"``
every stage runs the head on all M microbatches, its gradients are
whole on every rank and are not summed over pp, and the loss is every
rank's own. The stacked ``blocks`` leaves are never reduced over pp.

Virtual stages (``"interleaved"``, ``"1f1b"`` with V > 1). Chunk
v*P + d lives on rank d, but the stored layout keeps the reference's
contiguous pp blocks (its checkpoints and placements); so where V > 1
and P > 1 a rank all-gathers the block stack over pp for the step
(``GatherShard``: the gradients are reduce-scattered back to its block
in the backward) and restacks its chunks, as the reference's restack
makes XLA gather the non-resident chunks. At V = 1, or P = 1, every
chunk a rank runs is its own and nothing is gathered.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from kubeflow_tpu_torch.models.optim import AdamW, flatten, trainable
from kubeflow_tpu_torch.models.train import (
    TrainState,
    gradient_axes,
    reduce_gradients,
)
from kubeflow_tpu_torch.models.transformer import (
    LM_DATA_AXES,
    LM_TP_RULES,
    Block,
    LMConfig,
    TensorParallel,
    _leaf_specs,
    attention_core,
    check_tp_layout,
    init_params,
    lm_loss,
    rms_norm,
    tied_head,
)
from kubeflow_tpu_torch.ops.attention import check_segment_ids
from kubeflow_tpu_torch.ops.cross_entropy import next_token_targets
from kubeflow_tpu_torch.parallel.collectives import CopyToGroup, all_reduce
from kubeflow_tpu_torch.parallel.fsdp import GatherShard, gathered_call
from kubeflow_tpu_torch.parallel.mesh import param_sharding, path_key
from kubeflow_tpu_torch.parallel.pipeline import (
    gpipe,
    interleaved_gpipe,
    interleaved_one_f_one_b,
    one_f_one_b,
    stage_stack,
    stage_stack_interleaved,
)


def stacked_specs(cfg: LMConfig):
    """(path, shape) of every parameter in the pipelined layout, in the
    port's ``flatten`` naming: the embedding, each block leaf stacked
    over depth as ``blocks/<name>/<leaf>`` ``(layers, ...)``, the final
    norm."""
    seen = {}
    for path, shape, _ in _leaf_specs(cfg):
        if path.startswith("block_"):
            name = "blocks/" + path.split("/", 1)[1]
            seen.setdefault(name, (cfg.layers,) + tuple(shape))
        else:
            seen[path] = tuple(shape)
    return list(seen.items())


def stack_blocks(cfg: LMConfig, params: dict[str, Any]) -> dict[str, Any]:
    """The LM's per-block parameters (``block_<i>/...``) in the
    pipelined layout: ``blocks`` leaves stacked over depth (copies)."""
    first = params["block_0"]
    blocks = {name: {leaf: torch.stack([params[f"block_{i}"][name][leaf]
                                        for i in range(cfg.layers)])
                     for leaf in sub}
              for name, sub in first.items()}
    return {"embed": params["embed"], "blocks": blocks,
            "final_norm": params["final_norm"]}


def pp_param_sharding(mesh, path: tuple, leaf):
    """Placement rule for the pipelined state: depth-stacked ``blocks``
    leaves put their leading (stage) dim on pp, keep the LM's Megatron tp
    layout on the stack-shifted kernel dim, and take fsdp on the largest
    remaining dim — all via the canonical rule's ``stage_axis`` mode
    (``parallel.mesh.param_sharding``). Non-stacked leaves follow the
    plain canonical rule (pp inert, exactly like dp). ``path``: the
    leaf's keys (strings, or the reference's path entries)."""
    in_blocks = any(path_key(p) == "blocks" for p in path)
    return param_sharding(
        mesh, path, leaf,
        tp_rules=LM_TP_RULES if in_blocks else None,
        stage_axis="pp" if in_blocks else None,
    )


@dataclasses.dataclass(frozen=True)
class PipelinedLM:
    """The pipelined model over a parameter dict of ``{"embed",
    "blocks", "final_norm"}`` whose every ``blocks`` leaf is
    depth-stacked ``(layers, ...)``. Weightless, as the port's
    ``TransformerLM``: ``model(params, tokens)`` (= :meth:`apply`) on
    this rank's parameter shards.

    ``schedule``: "gpipe" (autograd backward, O(M) live microbatch
    state), "1f1b" (hand-scheduled PipeDream-flush backward, O(P) live
    state, inherent recompute), "interleaved" (virtual-stage forward,
    ``virtual_stages`` chunks a rank round robin, autograd backward);
    "1f1b" with ``virtual_stages`` > 1 combines both. ``use_flash``
    picks the attention core as ``build_lm`` does (default: the kernels
    on CUDA tensors, the plain core on CPU tensors)."""

    cfg: LMConfig
    mesh: Any
    num_microbatches: int
    remat: bool = False
    schedule: str = "gpipe"
    virtual_stages: int = 1
    use_flash: bool | None = None

    def __post_init__(self):
        cfg, mesh = self.cfg, self.mesh
        if self.schedule not in ("gpipe", "1f1b", "interleaved"):
            raise ValueError(
                f"schedule must be gpipe|1f1b|interleaved, got "
                f"{self.schedule!r}"
            )
        if self.schedule == "1f1b" and self.remat:
            raise ValueError(
                "remat has no effect under 1f1b (the interleaved "
                "backward recomputes stage internals inherently); "
                "drop remat=True"
            )
        if (self.virtual_stages != 1
                and self.schedule not in ("interleaved", "1f1b")):
            raise ValueError(
                "virtual_stages applies to the interleaved and 1f1b "
                "schedules only"
            )
        chunks = mesh.shape["pp"] * self.virtual
        if cfg.layers % chunks:
            raise ValueError(
                f"layers={cfg.layers} not divisible by "
                f"{chunks} pipeline chunks "
                f"(pp={mesh.shape['pp']}"
                + (f" x virtual={self.virtual_stages}"
                   if self.schedule == "interleaved" else "")
                + ")"
            )
        if cfg.moe_experts:
            raise ValueError(
                "MoE blocks are not pipelined (their aux losses do not "
                "cross the pipeline boundary); use ep on a non-pp mesh"
            )
        check_tp_layout(cfg, mesh)

    @property
    def virtual(self) -> int:
        return (self.virtual_stages
                if self.schedule in ("interleaved", "1f1b") else 1)

    @property
    def output(self) -> str:
        """"sharded" when the microbatches divide over pp (each stage then
        runs the head on its M / P), else "replicated"."""
        return ("sharded"
                if self.num_microbatches % self.mesh.shape["pp"] == 0
                else "replicated")

    @functools.cached_property
    def placements(self) -> dict[str, tuple]:
        """Each parameter's placement (:func:`pp_param_sharding`), keyed
        by its ``flatten`` path."""
        return {path: pp_param_sharding(self.mesh, tuple(path.split("/")),
                                        torch.empty(shape, device="meta"))
                for path, shape in stacked_specs(self.cfg)}

    @functools.cached_property
    def _layer_placements(self) -> dict[str, tuple]:
        """One layer's placements (the stage dim dropped), keyed
        ``blocks/<name>/<leaf>``, as ``gathered_call`` reads them."""
        return {path: placement[1:]
                for path, placement in self.placements.items()
                if path.startswith("blocks/")}

    @functools.cached_property
    def _block(self) -> Block:
        """The stage's block: the mesh's attention core (the ring on
        sp) and its tensor-parallel projections."""
        tp = TensorParallel(self.cfg, self.mesh, {
            f"block_0/{name}/kernel":
                self._layer_placements[f"blocks/{name}/kernel"]
            for name in LM_TP_RULES})
        return Block(self.cfg, attention_core(self.cfg, self.mesh,
                                              self.use_flash), tp)

    @functools.cached_property
    def _plain_block(self) -> Block:
        """Whole-sequence meshless block: the sequential reference."""
        return Block(self.cfg, attention_core(self.cfg, None,
                                              self.use_flash))

    def init(self, seed: int = 0, device=None) -> dict[str, Any]:
        """Whole parameters in the pipelined layout: the LM's
        ``init_params`` from ``seed`` (f32), blocks stacked over depth,
        so the same seed gives the same weights as ``create_lm_state``'s
        meshless LM. On the mesh's device unless ``device`` is given."""
        return stack_blocks(self.cfg, init_params(
            self.cfg, seed=seed,
            device=self.mesh.device if device is None else device))

    def _whole(self, params, path: str):
        group, name = path.split("/")
        leaf = params[group][name]
        if "fsdp" not in self.placements[path]:
            return leaf
        return GatherShard.apply(leaf, self.placements[path].index("fsdp"),
                                 self.mesh.group("fsdp"))

    def output_rows(self, rows: int) -> slice:
        """Which of ``rows`` given rows :meth:`apply` returns on this
        rank: its pp index's M / P microbatches with sharded output, all
        of them with replicated."""
        if self.output == "replicated":
            return slice(0, rows)
        part = rows // self.mesh.shape["pp"]
        start = self.mesh.index("pp") * part
        return slice(start, start + part)

    def _stage_fn(self, offset: int):
        block, mesh, dtype = self._block, self.mesh, self.cfg.dtype
        placements = self._layer_placements

        def stage_fn(stage_params, h, seg=None):
            # One unbind a leaf: its backward stacks the layers' gradients
            # once, where a select a layer would zero-fill the whole stack.
            layers = {name: {leaf: t.unbind(0) for leaf, t in sub.items()}
                      for name, sub in stage_params.items()}
            depth = len(next(iter(next(iter(layers.values())).values())))
            for j in range(depth):
                layer = {name: {leaf: t[j] for leaf, t in sub.items()}
                         for name, sub in layers.items()}
                h = gathered_call(
                    mesh, lambda w: block(w, h, seg, offset=offset),
                    layer, placements, "blocks", dtype)
            return h

        return stage_fn

    def _stage_params(self, blocks: dict[str, Any]):
        """This rank's block of the engine's stacked layout: (1, L/P,
        ...) for gpipe and plain 1f1b, (1, V, L/(V*P), ...) for the
        chunked engines (module docstring: the pp gather at V > 1)."""
        pp, virtual = self.mesh.shape["pp"], self.virtual
        if self.schedule != "interleaved" and virtual == 1:
            return stage_stack(blocks, 1)
        if virtual > 1 and pp > 1:
            group = self.mesh.group("pp")
            whole = {name: {leaf: GatherShard.apply(t, 0, group)
                            for leaf, t in sub.items()}
                     for name, sub in blocks.items()}
            d = self.mesh.index("pp")
            return {name: {leaf: t[d:d + 1] for leaf, t in sub.items()}
                    for name, sub in stage_stack_interleaved(
                        whole, pp, virtual).items()}
        return stage_stack_interleaved(blocks, 1, virtual)

    def _engine(self, stage_fn):
        common = dict(num_microbatches=self.num_microbatches,
                      output=self.output)
        virtual = self.virtual
        if self.schedule == "1f1b" and virtual > 1:
            return interleaved_one_f_one_b(
                stage_fn, self.mesh, virtual_stages=virtual, **common)
        if self.schedule == "1f1b":
            return one_f_one_b(stage_fn, self.mesh, **common)
        if self.schedule == "interleaved":
            return interleaved_gpipe(stage_fn, self.mesh, remat=self.remat,
                                     virtual_stages=virtual, **common)
        return gpipe(stage_fn, self.mesh, remat=self.remat, **common)

    def apply(self, params: dict[str, Any], tokens,
              segment_ids=None):
        """(rows, S) tokens -> f32 logits at :meth:`output_rows` of the
        rows and this rank's sp columns, RoPE at their global positions;
        ``params`` are this rank's shards. Every rank of a pp group
        passes the same rows, divisible by ``num_microbatches``.
        ``segment_ids`` (rows, S) enables packed batches: the ids
        microbatch alongside the tokens and ride the schedules as a
        per-microbatch side input."""
        cfg, mesh = self.cfg, self.mesh
        if segment_ids is not None:
            check_segment_ids(segment_ids)
        cols = mesh.slice("sp", tokens.shape[1])
        emb = self._whole(params, "embed/embedding")
        x = emb[tokens[:, cols]].to(cfg.dtype)
        seg = None if segment_ids is None else segment_ids[:, cols]
        run = self._engine(self._stage_fn(cols.start))
        x = run(self._stage_params(params["blocks"]), x, seg)
        scale = self._whole(params, "final_norm/scale")
        if self.output == "sharded":
            group = mesh.group("pp")
            emb = CopyToGroup.apply(emb, group)
            scale = CopyToGroup.apply(scale, group)
        return tied_head(rms_norm(scale, x), emb, cfg.dtype)

    __call__ = apply

    def sequential_apply(self, params: dict[str, Any], tokens,
                         segment_ids=None):
        """The same computation with a plain sequential layer loop and no
        pipeline or collective: the numerical reference of the schedules,
        on WHOLE parameters (``blocks`` leaves (layers, ...)) and whole
        sequences, the meshless block."""
        cfg = self.cfg
        if segment_ids is not None:
            check_segment_ids(segment_ids)
        emb = params["embed"]["embedding"]
        x = emb[tokens].to(cfg.dtype)
        for i in range(cfg.layers):
            layer = {name: {leaf: t[i] for leaf, t in sub.items()}
                     for name, sub in params["blocks"].items()}
            x = self._plain_block(layer, x, segment_ids)
        x = rms_norm(params["final_norm"]["scale"], x)
        return tied_head(x, emb, cfg.dtype)


def pp_state_shardings(state: TrainState, mesh) -> dict:
    """Each leaf's placement for a whole pipelined ``state`` on ``mesh``
    (:func:`pp_param_sharding`; the optimizer's moments take their
    parameter's): ``{"params": {path: placement}, "batch_stats": {}}``."""
    return {"params": {path: pp_param_sharding(mesh, tuple(path.split("/")),
                                               leaf)
                       for path, leaf in flatten(state.params)},
            "batch_stats": {}}


def create_pp_lm_state(model: PipelinedLM, seed: int = 0,
                       tx=None) -> TrainState:
    """TrainState for the pipelined LM, born sharded: the whole state
    from ``model.init(seed)`` in host memory, then each rank moves only
    its shard of every leaf to the mesh's device at
    :func:`pp_param_sharding` (blocks (pp, fsdp)-sharded), the
    optimizer's moments at their parameter's placement. AdamW by
    default, as the reference's ``optax.adamw(3e-4, weight_decay=0.01,
    mu_dtype=bfloat16)``."""
    from kubeflow_tpu_torch.models.convert import shard_state

    tx = tx or AdamW(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
    params = trainable(model.init(seed, device="cpu"))
    state = TrainState(step=0, params=params, opt_state=tx.init(params),
                       tx=tx, apply_fn=model)
    return shard_state(state, model.mesh)


def make_pp_lm_train_step(model: PipelinedLM):
    """The pipelined train step: ``step(state, batch)`` with batch =
    {"tokens": (B, S) int, optional "segment_ids": (B, S)}, every rank
    passing the WHOLE batch; updates the state IN PLACE and returns
    ``(state, {"loss"})``, the whole batch's mean on every rank.

    The batch shards over (dp, fsdp) and the sequence over sp, exactly
    like the mesh LM step (pp leaves the rows alone: every pp rank takes
    the same rows); the pipeline splits the rows into microbatches. The
    loss's targets come from the whole batch (``next_token_targets``),
    and each rank's loss is its positions' NLL sum over the WHOLE
    batch's count: its :meth:`~PipelinedLM.output_rows` of its rows at
    its sp columns. Gradients are then summed over the data axes
    (``gradient_axes`` of ``LM_DATA_AXES``; the pp sums of the replicated
    leaves ran inside the backward, module docstring) and AdamW runs on
    each rank's shards. The reported loss sums the ranks' shares over
    the data axes, and over pp with sharded output."""
    mesh = model.mesh

    def step(state, batch):
        if state.apply_fn != model:
            raise ValueError("the state's model is not this step's: "
                             "create_pp_lm_state(model)")
        if state.placements["params"] != model.placements:
            raise ValueError("the state's placements are not the "
                             "pipelined layout: create_pp_lm_state(model) "
                             "or shard_state(state, mesh)")
        tokens, seg = batch["tokens"], batch.get("segment_ids")
        targets, valid = next_token_targets(tokens, seg)
        rows = mesh.slice(("dp", "fsdp"), tokens.shape[0])
        cols = mesh.slice("sp", tokens.shape[1])
        seg = None if seg is None else seg[rows]
        out = model.output_rows(rows.stop - rows.start)
        logits = model(state.params, tokens[rows], seg)
        ce = lm_loss(logits, targets=targets[rows][out, cols],
                     valid=valid[rows][out, cols],
                     count=valid.sum().clamp_min(1.0))
        paths = [path for path, _ in flatten(state.params)]
        grads = torch.autograd.grad(ce,
                                    [t for _, t in flatten(state.params)])
        grads = reduce_gradients(mesh, grads, [
            gradient_axes(model.placements[p], LM_DATA_AXES) for p in paths])
        with torch.no_grad():
            state.tx.update(grads, state.opt_state, state.params)
        loss = all_reduce(ce.detach().clone(), mesh.group(LM_DATA_AXES))
        if model.output == "sharded":
            loss = all_reduce(loss, mesh.group("pp"))
        state.step += 1
        return state, {"loss": loss}

    return step


__all__ = ["PipelinedLM", "pp_param_sharding", "create_pp_lm_state",
           "make_pp_lm_train_step", "stack_blocks", "stacked_specs",
           "pp_state_shardings"]

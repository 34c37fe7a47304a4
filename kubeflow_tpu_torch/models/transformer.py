"""Decoder-only transformer LM: config, norm, head, the dense forward,
the loss and the LM train step.

The counterpart of ``kubeflow_tpu/models/transformer.py``, its MoE
blocks included. Parameters follow the flax names and the flax ``(in,
out)`` kernel layout, so the decode path (models/decoding.py) multiplies
them as the reference does: ``embed/embedding`` (vocab, dim),
``block_<i>/{q_proj,k_proj,v_proj,proj,up,down}/kernel``,
``block_<i>/RMSNorm_{0,1}/scale`` and ``final_norm/scale``; an MoE block
(every ``moe_every``-th) holds ``block_<i>/moe/{router/kernel (D, E),
experts_up (E, D, H), experts_down (E, H, D)}`` in place of up/down.

As in flax, the model holds no weights: ``TransformerLM(cfg,
attn_impl)`` is applied to a parameter dict, ``model(params, tokens)``.
Training differentiates that call with ``torch.autograd.grad`` over the
dict's leaves (which then require grad); serving calls it under
``torch.no_grad`` and records nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models.optim import AdamW, flatten, trainable
from kubeflow_tpu_torch.obs.profile import span
from kubeflow_tpu_torch.models.train import (
    TrainState,
    gradient_axes,
    reduce_gradients,
)
from kubeflow_tpu_torch.ops.attention import (
    _attend,
    apply_rope,
    check_segment_ids,
    mha_reference,
)
from kubeflow_tpu_torch.ops.cross_entropy import (
    fused_lm_loss,
    masked_mean,
    next_token_targets,
)
from kubeflow_tpu_torch.ops.ring import ring_attention
from kubeflow_tpu_torch.parallel.collectives import (
    CopyToGroup,
    GatherFromGroup,
    ReduceFromGroup,
    ScatterToGroup,
    all_reduce,
)
from kubeflow_tpu_torch.parallel.fsdp import GatherShard, gathered_call
from kubeflow_tpu_torch.parallel.mesh import param_sharding

AttnImpl = Callable[..., torch.Tensor]  # (q, k, v, causal=, segment_ids=)

# Megatron tp layout for this model's kernels: column-parallel into the
# block (q/k/v/up: out dim -> tp), row-parallel out (proj/down: in dim
# -> tp), so each pair costs one all-reduce. Passed to
# parallel.param_sharding by create_lm_state (tp is opt-in per model).
LM_TP_RULES = {
    "q_proj": 1, "k_proj": 1, "v_proj": 1, "up": 1,
    "proj": 0, "down": 0,
}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Same fields and checks as the reference config; ``dtype`` is a
    torch dtype (the activation / compute dtype)."""

    vocab: int = 32000
    layers: int = 4
    dim: int = 256
    heads: int = 4
    mlp_ratio: int = 4
    dtype: Any = torch.float32
    attn_window: int | None = None
    kv_heads: int | None = None
    moe_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_router: str = "topk"
    loss_impl: str = "auto"
    ce_block: int = 4096

    def __post_init__(self):
        if self.attn_window is not None and self.attn_window < 1:
            raise ValueError(f"attn_window={self.attn_window} must be >= 1")
        if self.kv_heads is not None and (
                self.kv_heads < 1 or self.heads % self.kv_heads):
            raise ValueError(f"kv_heads={self.kv_heads} must be >= 1 and "
                             f"divide heads={self.heads}")
        if self.moe_experts and not (1 <= self.moe_top_k
                                     <= self.moe_experts):
            raise ValueError(f"moe_top_k={self.moe_top_k} must be in "
                             f"[1, moe_experts={self.moe_experts}]")
        if self.moe_router not in ("topk", "expert_choice"):
            raise ValueError(f"moe_router must be topk|expert_choice, got "
                             f"{self.moe_router!r}")
        if self.loss_impl not in ("auto", "fused", "dense"):
            raise ValueError(f"loss_impl must be auto|fused|dense, got "
                             f"{self.loss_impl!r}")
        if self.ce_block < 1:
            raise ValueError(f"ce_block={self.ce_block} must be >= 1")

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def num_kv_heads(self) -> int:
        return self.heads if self.kv_heads is None else self.kv_heads


def rms_norm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm in f32 with eps 1e-6, cast back to x.dtype (shared by the
    forward and the decode path so the two cannot drift)."""
    xf = x.float()
    norm = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (norm * scale.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's GELU: flax/jax default to the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def tied_head(x: torch.Tensor, embedding: torch.Tensor, dtype) -> torch.Tensor:
    """Logits against the tied embedding: operands in the model dtype,
    f32 accumulation, f32 logits."""
    return torch.einsum("bsd,vd->bsv", x.to(dtype).float(),
                        embedding.to(dtype).float())


def _dense(h: torch.Tensor, kernel: torch.Tensor, dtype) -> torch.Tensor:
    """flax Dense(use_bias=False, dtype=dtype): (.., in) @ (in, out) in
    the compute dtype with f32 accumulation, rounded to the dtype."""
    return (h.to(dtype).float() @ kernel.to(dtype).float()).to(dtype)


def is_moe_block(cfg: LMConfig, i: int) -> bool:
    """Block ``i`` swaps its FFN for the MoE layer: every
    ``moe_every``-th block of an MoE config, as the reference places
    them."""
    return cfg.moe_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1


def _moe_capacity(cfg: LMConfig, s: int) -> int:
    """Per-expert slots for a sequence of ``s`` tokens: top-k scales with
    k (each token makes k assignments); expert choice takes factor * S /
    E tokens an expert, k plays no role."""
    cap_k = cfg.moe_top_k if cfg.moe_router == "topk" else 1
    return max(1, int(cfg.moe_capacity_factor * cap_k * s / cfg.moe_experts))


def _topk_choices(probs, k: int) -> list[torch.Tensor]:
    """Each token's k expert choices as (B, S, E) f32 one-hots, first
    choice first: argmax, then argmax with the earlier choices masked
    out."""
    masked, onehots = probs, []
    for _ in range(k):
        oh = F.one_hot(torch.argmax(masked, dim=-1), probs.shape[-1]).float()
        onehots.append(oh)
        masked = masked * (1.0 - oh)
    return onehots


def _load_balance_aux(first, probs, data=None):
    """Switch's load-balance aux (eq. 4, over first choices): E times the
    sum over experts of the fraction of tokens times the fraction of
    router mass. Both fractions are means over every token of the batch:
    where ranks split the rows (``data``: their group and its size) the
    token counts are all-reduced over them and each rank's router mass is
    its share of the global one, so the value is the global aux while its
    gradient is this rank's part of it (the step sums gradients over the
    data axes)."""
    e = probs.shape[-1]
    n = probs.shape[0] * probs.shape[1]
    tokens, mass = first.sum(dim=(0, 1)), probs.sum(dim=(0, 1))
    if data is not None:
        n *= data[1]
        tokens = all_reduce(tokens, data[0])
    share = e * (tokens / n * (mass / n)).sum()
    if data is None:
        return share
    whole = all_reduce(share.detach().clone(), data[0])
    return share + (whole - share).detach()


def _topk_routing(cfg: LMConfig, probs, cap: int, sow: dict | None,
                  data=None):
    """Tokens choose experts (Switch k=1, GShard k=2;
    :func:`_topk_choices`), each choice's gate its probability; with k > 1
    the selected gates are renormalised (Mixtral). Choice order is priority
    order (GShard): every first choice claims a slot of its expert's
    ``cap`` before any second choice, and an assignment past the capacity
    is dropped (the token falls through the residual). Returns the
    (B, S, E, C) f32 dispatch and combine tensors; ``sow`` receives the
    load-balance aux (:func:`_load_balance_aux`).

    ``torch.argmax`` takes the first of tied maxima, as ``jnp.argmax``
    does, so the choices agree with the reference's wherever the router
    probabilities are untied (random probabilities always are)."""
    b, s, e = probs.shape
    onehots = _topk_choices(probs.detach(), cfg.moe_top_k)
    masked, gates = probs, []
    for oh in onehots:
        gates.append((masked * oh).sum(-1))
        masked = masked * (1.0 - oh)
    if cfg.moe_top_k > 1:
        denom = sum(gates)
        gates = [g / (denom + 1e-9) for g in gates]
    if sow is not None:
        sow["moe_aux"] = _load_balance_aux(onehots[0], probs, data)
    dispatch_t = probs.new_zeros((b, s, e, cap))
    combine_t = probs.new_zeros((b, s, e, cap))
    claimed = probs.new_zeros((b, 1, e))
    for oh, gate in zip(onehots, gates):
        position = (torch.cumsum(oh, dim=1) + claimed) * oh - 1.0
        keep = ((position >= 0) & (position < cap)).float()
        slot = F.one_hot(position.clamp(0, cap - 1).long(), cap).float()
        dt = keep[..., None] * slot
        dispatch_t = dispatch_t + dt
        combine_t = combine_t + dt * gate[..., None, None]
        claimed = claimed + oh.sum(dim=1, keepdim=True)
    return dispatch_t, combine_t


def _expert_choice_routing(probs, cap: int):
    """Experts choose tokens (expert-choice routing): each expert takes
    its top-``cap`` tokens of the sequence by router affinity, so every
    expert fills its slots and nothing is dropped for capacity; a token
    may be taken by several experts or none. Not causal: decode refuses
    it. ``torch.topk`` promises no order among tied values; untied
    (random) probabilities select as the reference does."""
    _, s, _ = probs.shape
    gates, idx = torch.topk(probs.transpose(1, 2), min(cap, s), dim=-1)
    sel = F.one_hot(idx, s).float()                     # (B, E, C, S)
    dispatch_t = sel.permute(0, 3, 1, 2)                # (B, S, E, C)
    combine_t = (sel * gates[..., None]).permute(0, 3, 1, 2)
    return dispatch_t, combine_t


def moe_route(cfg: LMConfig, p: dict[str, Any], x,
              sow: dict | None = None, data=None):
    """The router of one block's ``moe`` params over x (B, S, D), in f32
    (its softmax too), and the configured routing: the (B, S, E, C) f32
    dispatch and combine tensors. ``sow`` receives ``moe_aux`` (top-k
    only), ``moe_expert_load`` (E,) and ``moe_slot_max``; where ranks
    split the rows (``data``: their group and its size) all three are
    the whole batch's."""
    cap = _moe_capacity(cfg, x.shape[1])
    probs = torch.softmax(x.float() @ p["router"]["kernel"].float(), dim=-1)
    if cfg.moe_router == "expert_choice":
        dispatch_t, combine_t = _expert_choice_routing(probs, cap)
    else:
        dispatch_t, combine_t = _topk_routing(cfg, probs, cap, sow, data)
    if sow is not None:
        with torch.no_grad():
            load = dispatch_t.sum(dim=(0, 1, 3))
            slot_max = dispatch_t.sum(dim=1).max()
            if data is not None:
                load = all_reduce(load, data[0])
                dist.all_reduce(slot_max, op=dist.ReduceOp.MAX,
                                group=data[0])
            sow["moe_expert_load"], sow["moe_slot_max"] = load, slot_max
    return dispatch_t, combine_t


def moe_dispatch(cfg: LMConfig, x, dispatch_t):
    """Tokens to the expert-major layout: (E, B, C, D) in ``cfg.dtype``
    (E: the experts of ``dispatch_t``)."""
    dt = cfg.dtype
    return torch.einsum("bsec,bsd->ebcd", dispatch_t.to(dt).float(),
                        x.to(dt).float()).to(dt)


def moe_experts(cfg: LMConfig, p: dict[str, Any], expert_in):
    """Every expert's two-layer tanh-GELU FFN on its slots."""
    dt = cfg.dtype
    h = torch.einsum("ebcd,edh->ebch", expert_in.float(),
                     p["experts_up"].to(dt).float()).to(dt)
    return torch.einsum("ebch,ehd->ebcd", gelu(h).float(),
                        p["experts_down"].to(dt).float()).to(dt)


def moe_combine(cfg: LMConfig, combine_t, expert_out, group=None):
    """The experts' outputs back to (B, S, D), weighted by the combine
    tensor rounded to ``cfg.dtype`` as the reference casts it. With a
    ``group`` (ep) each rank holds some of the experts: their f32 partial
    sums are all-reduced before the rounding, as one product is."""
    dt = cfg.dtype
    out = torch.einsum("bsec,ebcd->bsd", combine_t.to(dt).float(),
                       expert_out.float())
    if group is not None:
        out = ReduceFromGroup.apply(out, group)
    return out.to(dt)


class ExpertParallel:
    """The MoE layer on a mesh, computing what the reference's GSPMD
    computes on its sharded ``experts_*`` stacks, with the collectives
    written out.

    - Routing is over the whole sequence (capacity from the global S,
      top-k slots a cumsum over it, expert choice over all of it), so
      under sp the layer all-gathers its input's columns
      (:class:`GatherFromGroup`), routes and runs the experts on every
      column, and keeps this rank's (:class:`ScatterToGroup`, whose
      backward all-gathers the gradient): the layer's backward is whole
      and equal on every sp rank, and so are its leaves' gradients.
    - ep replicates the batch: every ep rank routes the same rows
      alike and runs its E / ep experts (the stacks' ep blocks) on its
      slice of the dispatch. ``x`` enters the local experts through
      :class:`CopyToGroup` and the combine tensor through
      :class:`ScatterToGroup` along the experts (their gradients, which
      each rank holds for its experts only, are summed / gathered over
      ep), and the combined output leaves through
      :class:`ReduceFromGroup`. Every leaf outside the stacks then gets
      the same gradient on every ep rank.
    - The aux's two means and the load diagnostics count every row of
      the batch: where the rows are this rank's block of it
      (``split_rows``, as the train step passes them) their sums are
      all-reduced over (dp, fsdp).

    Where ``param_sharding`` left the stacks off ep (E does not divide by
    ep) every rank runs every expert."""

    def __init__(self, cfg: LMConfig, mesh, placements: dict):
        first = next(i for i in range(cfg.layers) if is_moe_block(cfg, i))
        self.mesh = mesh
        self.on_sp = mesh.shape["sp"] > 1
        self.on_ep = "ep" in placements[f"block_{first}/moe/experts_up"]

    def __call__(self, cfg: LMConfig, p: dict[str, Any], x,
                 sow: dict | None = None,
                 split_rows: bool = False) -> torch.Tensor:
        mesh = self.mesh
        if self.on_sp:
            x = GatherFromGroup.apply(x, 1, mesh.group("sp"))
        data = (mesh.group(("dp", "fsdp")), mesh.size(("dp", "fsdp")))
        dispatch_t, combine_t = moe_route(cfg, p, x, sow,
                                          data if split_rows else None)
        ep = mesh.group("ep") if self.on_ep else None
        if ep is not None:
            experts = p["experts_up"].shape[0]
            local = slice(mesh.index("ep") * experts,
                          (mesh.index("ep") + 1) * experts)
            x = CopyToGroup.apply(x, ep)
            dispatch_t = dispatch_t[:, :, local]
            combine_t = ScatterToGroup.apply(combine_t, 2, ep)
        expert_out = moe_experts(cfg, p, moe_dispatch(cfg, x, dispatch_t))
        out = moe_combine(cfg, combine_t, expert_out, ep)
        if self.on_sp:
            out = ScatterToGroup.apply(out, 1, mesh.group("sp"))
        return out


def moe_ffn(cfg: LMConfig, p: dict[str, Any], x,
            sow: dict | None = None) -> torch.Tensor:
    """The reference's ``MoEFFN`` over one block's ``moe`` params: (B, S,
    D) -> (B, S, D). The router runs in f32; dispatch, the experts and
    the combine are dense products in ``cfg.dtype`` with f32
    accumulation (:func:`moe_route`, :func:`moe_dispatch`,
    :func:`moe_experts`, :func:`moe_combine`). On a mesh the model runs
    :class:`ExpertParallel` instead."""
    dispatch_t, combine_t = moe_route(cfg, p, x, sow)
    expert_out = moe_experts(cfg, p, moe_dispatch(cfg, x, dispatch_t))
    return moe_combine(cfg, combine_t, expert_out)


def _leaf_specs(cfg: LMConfig):
    """(path, shape, init) of every parameter, in draw order: ``init``
    is the std of an N(0, std^2) draw, ``"router"`` for an MoE router
    (drawn in f32), or None for a norm scale of ones (f32)."""
    d, hd = cfg.dim, cfg.head_dim
    kv = cfg.num_kv_heads * hd
    hidden = cfg.mlp_ratio * d
    e = cfg.moe_experts
    yield "embed/embedding", (cfg.vocab, d), d ** -0.5
    for i in range(cfg.layers):
        blk = f"block_{i}"
        yield f"{blk}/RMSNorm_0/scale", (d,), None
        yield f"{blk}/q_proj/kernel", (d, d), d ** -0.5
        yield f"{blk}/k_proj/kernel", (d, kv), d ** -0.5
        yield f"{blk}/v_proj/kernel", (d, kv), d ** -0.5
        yield f"{blk}/proj/kernel", (d, d), d ** -0.5
        yield f"{blk}/RMSNorm_1/scale", (d,), None
        if is_moe_block(cfg, i):
            yield f"{blk}/moe/router/kernel", (d, e), "router"
            yield f"{blk}/moe/experts_up", (e, d, hidden), (e * d) ** -0.5
            yield f"{blk}/moe/experts_down", (e, hidden, d), (
                e * hidden) ** -0.5
        else:
            yield f"{blk}/up/kernel", (d, hidden), d ** -0.5
            yield f"{blk}/down/kernel", (hidden, d), hidden ** -0.5
    yield "final_norm/scale", (d,), None


def _set(tree: dict, path: str, leaf) -> None:
    *groups, name = path.split("/")
    for key in groups:
        tree = tree.setdefault(key, {})
    tree[name] = leaf


def init_params(cfg: LMConfig, seed: int = 0, device=None,
                dtype=torch.float32) -> dict[str, Any]:
    """Seeded random parameters in the reference's names and layouts:
    Dense kernels ~ N(0, 1/fan_in) (lecun normal, untruncated), the
    embedding ~ N(0, 1/dim), norm scales 1; an MoE block's router in f32
    and its expert weights with fan-in counted over (E, in), as flax's
    lecun normal counts it for a 3-d kernel. Drawn on the CPU from one
    ``torch.Generator`` (the same numbers on every device), then moved."""
    gen = torch.Generator().manual_seed(int(seed))
    params: dict[str, Any] = {}
    for path, shape, init in _leaf_specs(cfg):
        if init is None:
            leaf = torch.ones(shape, device=device, dtype=torch.float32)
        elif init == "router":
            leaf = (torch.randn(shape, generator=gen)
                    * cfg.dim ** -0.5).to(device=device)
        else:
            leaf = (torch.randn(shape, generator=gen) * init).to(
                device=device, dtype=dtype)
        _set(params, path, leaf)
    return params


def lm_placements(cfg: LMConfig, mesh) -> dict[str, tuple]:
    """Each parameter's placement on ``mesh`` (``param_sharding`` with
    :data:`LM_TP_RULES`), keyed by its ``flatten`` path."""
    return {path: param_sharding(mesh, tuple(path.split("/")),
                                 torch.empty(shape, device="meta"),
                                 tp_rules=LM_TP_RULES)
            for path, shape, _ in _leaf_specs(cfg)}


def param_count(params: dict[str, Any]) -> int:
    total = 0
    for value in params.values():
        if isinstance(value, dict):
            total += param_count(value)
        elif isinstance(value, torch.Tensor):
            total += value.numel()
    return total


def train_flops_per_sequence(cfg: LMConfig, seq: int) -> float:
    """Training FLOPs of one sequence of ``seq`` tokens (forward and
    backward, 3x the forward): 6 x the parameters that take part in a
    product x ``seq``, plus 6 x layers x seq^2 x dim for causal
    attention. The product parameters are every block's q/k/v/proj and
    FFN (an MoE block's router and a token's ``moe_top_k`` experts) and
    the tied head; under a window the attention term counts the live
    query-key pairs, seq * w - w^2 / 2 in place of seq^2 / 2."""
    d = cfg.dim
    attn = 2 * d * d + 2 * d * cfg.num_kv_heads * cfg.head_dim
    ffn = 2 * d * d * cfg.mlp_ratio
    blocks = sum(attn + (d * cfg.moe_experts + cfg.moe_top_k * ffn
                         if is_moe_block(cfg, i) else ffn)
                 for i in range(cfg.layers))
    w = cfg.attn_window
    pairs = seq * seq / 2 if w is None or w >= seq else seq * w - w * w / 2
    return 6.0 * (blocks + cfg.vocab * d) * seq + 12.0 * cfg.layers * d * pairs


def _plain_attention(window: int | None) -> AttnImpl:
    """The plain attention core: :func:`mha_reference` in f32 with the
    config's window, the reference's core off the accelerator."""
    def plain(q, k, v, causal=True, segment_ids=None):
        return mha_reference(q, k, v, causal=causal, window=window,
                             segment_ids=segment_ids)
    return plain


class TensorParallel:
    """The block's projections on a mesh whose ``tp`` axis shards them
    (Megatron's layout, :data:`LM_TP_RULES`), run on plain local tensors
    with the collectives written out.

    Where a block's column kernels (q/k/v, up) and its row kernel (proj,
    down) are all sharded on whole heads (heads and kv heads divide by
    tp; the hidden width for the MLP), each rank computes its own heads:
    :class:`CopyToGroup` before the column products (the input's
    gradient is all-reduced), :class:`ReduceFromGroup` after the row
    product (its f32 partial sums are all-reduced, then rounded to the
    dtype, as one product is). Elsewhere (4 heads at tp=8: a column
    shard cuts a head) the sharded column outputs are gathered over tp
    (:class:`GatherFromGroup`), attention runs on every head, replicated,
    and the row product takes this rank's columns of its input
    (:class:`ScatterToGroup`). A kernel that ``param_sharding`` left
    replicated (its dim does not divide by tp) is a plain product."""

    def __init__(self, cfg: LMConfig, mesh, placements: dict):
        tp = mesh.shape["tp"]
        self.cfg, self.mesh = cfg, mesh
        self.sharded = {name: "tp" in placements[f"block_0/{name}/kernel"]
                        for name in LM_TP_RULES}
        self.local = {
            "attention": (all(self.sharded[n] for n in
                              ("q_proj", "k_proj", "v_proj", "proj"))
                          and cfg.heads % tp == 0
                          and cfg.num_kv_heads % tp == 0),
            "mlp": self.sharded["up"] and self.sharded["down"]}

    @property
    def group(self):
        return self.mesh.group("tp")

    def column(self, h, p, names, part: str) -> list:
        """``h @ kernel`` for each column kernel of ``names``: this
        rank's heads or hidden units when ``part`` runs local, else the
        whole output on every rank."""
        dtype = self.cfg.dtype
        h_tp = (CopyToGroup.apply(h, self.group)
                if any(self.sharded[n] for n in names) else None)
        outs = []
        for name in names:
            w = p[name]["kernel"]
            if not self.sharded[name]:
                outs.append(_dense(h, w, dtype))
                continue
            y = _dense(h_tp, w, dtype)
            if not self.local[part]:
                y = GatherFromGroup.apply(y, -1, self.group)
            outs.append(y)
        return outs

    def row(self, x, p, name: str, part: str):
        """``x @ kernel`` for a row kernel; ``x`` holds this rank's
        columns when ``part`` runs local, else all of them."""
        dtype, w = self.cfg.dtype, p[name]["kernel"]
        if not self.sharded[name]:
            return _dense(x, w, dtype)
        if not self.local[part]:
            x = ScatterToGroup.apply(x, -1, self.group)
        partial = x.to(dtype).float() @ w.to(dtype).float()
        return ReduceFromGroup.apply(partial, self.group).to(dtype)


class Block:
    """Pre-norm block: attention (GQA, RoPE, causal) + dense tanh-GELU
    FFN, or the MoE layer (``use_moe``), applied to one ``block_<i>``
    parameter dict. ``attn_impl`` is the attention core; without one,
    :func:`_plain_attention`. ``tp`` runs the projections tensor-parallel
    (:class:`TensorParallel`) and ``ep`` the MoE layer on the mesh
    (:class:`ExpertParallel`); ``offset`` is the global position of the
    first row (a sequence shard's RoPE), ``split_rows`` whether the rows
    are this rank's block of the batch. ``sow`` receives the MoE
    intermediates."""

    def __init__(self, cfg: LMConfig, attn_impl: AttnImpl | None = None,
                 tp: TensorParallel | None = None,
                 ep: ExpertParallel | None = None):
        self.cfg = cfg
        self.attn_impl = attn_impl or _plain_attention(cfg.attn_window)
        self.tp = tp
        self.ep = ep

    def _column(self, h, p, names, part):
        if self.tp is None:
            return [_dense(h, p[n]["kernel"], self.cfg.dtype) for n in names]
        return self.tp.column(h, p, names, part)

    def _row(self, x, p, name, part):
        if self.tp is None:
            return _dense(x, p[name]["kernel"], self.cfg.dtype)
        return self.tp.row(x, p, name, part)

    def __call__(self, p: dict[str, Any], x, segment_ids=None,
                 use_moe: bool = False, sow: dict | None = None,
                 offset: int = 0, split_rows: bool = False):
        cfg = self.cfg
        b, s, _ = x.shape
        h = rms_norm(p["RMSNorm_0"]["scale"], x)
        q, k, v = self._column(h, p, ("q_proj", "k_proj", "v_proj"),
                               "attention")

        def heads(t):
            return t.reshape(b, s, -1, cfg.head_dim).transpose(1, 2)

        q = apply_rope(heads(q), offset=offset)
        k = apply_rope(heads(k), offset=offset)
        out = self.attn_impl(q, k, heads(v), causal=True,
                             segment_ids=segment_ids)
        out = out.transpose(1, 2).reshape(b, s, -1)
        x = x + self._row(out, p, "proj", "attention")
        h = rms_norm(p["RMSNorm_1"]["scale"], x)
        if use_moe and self.ep is not None:
            return x + self.ep(cfg, p["moe"], h, sow, split_rows)
        if use_moe:
            return x + moe_ffn(cfg, p["moe"], h, sow)
        h, = self._column(h, p, ("up",), "mlp")
        return x + self._row(gelu(h), p, "down", "mlp")


class TransformerLM:
    """The full-sequence forward over a parameter dict in the reference
    layout: ``model(params, tokens)``, (B, S) tokens -> (B, S, vocab) f32
    logits (or the post-norm hidden states with ``return_hidden``).
    ``segment_ids`` (B, S) masks attention to each packed document; their
    order is checked once here, not in every layer.
    ``return_intermediates`` also returns what the MoE blocks sow (the
    reference's ``mutable=["intermediates"]``): ``{"block_<i>":
    {"moe_aux", "moe_expert_load", "moe_slot_max"}}``, ``moe_aux`` for
    top-k routing only; empty for a dense model.

    On a ``mesh`` (``build_lm(cfg, mesh)``) the model holds each
    parameter's placement (:func:`lm_placements`) and
    ``model(params, tokens)`` takes this rank's parameter shards and
    whole sequences: rows of its choosing (the train step gives it its
    (dp, fsdp) rows), every column. It returns those rows at this rank's
    sp columns, RoPE at their global positions. Under fsdp the embedding
    is all-gathered once (:meth:`embedding`; the lookup and the tied head
    share it), and each block's sharded leaves as the block runs
    (``parallel.fsdp.gathered_call``): gathered again in the block's
    backward, their gradients reduce-scattered there."""

    def __init__(self, cfg: LMConfig, attn_impl: AttnImpl | None = None,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.placements = None if mesh is None else lm_placements(cfg, mesh)
        tp = ep = None
        if mesh is not None:
            tp = TensorParallel(cfg, mesh, self.placements)
            if cfg.moe_experts:
                ep = ExpertParallel(cfg, mesh, self.placements)
        self.block = Block(cfg, attn_impl, tp, ep)

    def _whole(self, params: dict[str, Any], path: str):
        group, name = path.split("/")
        leaf = params[group][name]
        if self.mesh is None or "fsdp" not in self.placements[path]:
            return leaf
        return GatherShard.apply(leaf, self.placements[path].index("fsdp"),
                                 self.mesh.group("fsdp"))

    def embedding(self, params: dict[str, Any]):
        """The whole (vocab, dim) embedding from this rank's parameters:
        all-gathered over fsdp where fsdp shards it (its gradient is
        reduce-scattered back in the backward), else the leaf itself."""
        return self._whole(params, "embed/embedding")

    def __call__(self, params: dict[str, Any], tokens, segment_ids=None,
                 return_hidden=False, return_intermediates=False,
                 embedding=None, split_rows=False):
        """(rows, S) tokens -> (rows, S / sp, vocab) f32 logits (or hidden
        states) at this rank's sequence shard; meshless, the whole
        sequence from position 0. ``embedding`` is :meth:`embedding`'s
        result when the caller has it already (the fused loss reads it
        too). ``split_rows``: the rows are this rank's (dp, fsdp) block of
        the batch (the train step's), so the MoE layer's batch means and
        diagnostics all-reduce over those axes; by default every rank
        holds the rows it is given whole."""
        cfg, mesh = self.cfg, self.mesh
        if segment_ids is not None:
            check_segment_ids(segment_ids)
        cols = (slice(0, tokens.shape[1]) if mesh is None
                else mesh.slice("sp", tokens.shape[1]))
        emb = self.embedding(params) if embedding is None else embedding
        x = emb[tokens[:, cols]].to(cfg.dtype)
        seg = None if segment_ids is None else segment_ids[:, cols]
        intermediates: dict[str, dict] = {}
        for i in range(cfg.layers):
            use_moe = is_moe_block(cfg, i)
            sow = None
            if use_moe and return_intermediates:
                sow = intermediates.setdefault(f"block_{i}", {})
            x = gathered_call(
                mesh, lambda w: self.block(w, x, seg, use_moe=use_moe,
                                           sow=sow, offset=cols.start,
                                           split_rows=split_rows),
                params[f"block_{i}"], self.placements, f"block_{i}",
                cfg.dtype)
        x = rms_norm(self._whole(params, "final_norm/scale"), x)
        out = x if return_hidden else tied_head(x, emb, cfg.dtype)
        return (out, intermediates) if return_intermediates else out


def check_tp_layout(cfg: LMConfig, mesh) -> None:
    """Reject GQA configs whose kv heads cannot cut cleanly over tp.

    With explicit GQA, Megatron column-sharding should cut k/v on
    whole-kv-head boundaries; kv_heads < tp would either split a kv head
    across devices or silently replicate the k/v kernels while q stays
    sharded. (Plain MHA keeps the reference's behaviour: tp may
    subdivide head_dim; the model then gathers q/k/v over tp.)"""
    if (
        mesh is not None
        and mesh.shape.get("tp", 1) > 1
        and cfg.kv_heads is not None
        and cfg.kv_heads != cfg.heads
        and cfg.kv_heads % mesh.shape["tp"]
    ):
        raise ValueError(
            f"kv_heads={cfg.kv_heads} must be divisible by "
            f"tp={mesh.shape['tp']} for the Megatron layout"
        )


def attention_core(cfg: LMConfig, mesh=None,
                   use_flash: bool | None = None) -> AttnImpl:
    """The LM's attention core: ring attention over the mesh's ``sp``
    group when sp > 1 (:func:`ring_attention`); else the flash kernels
    (``use_flash=True``; their plain twins on CPU tensors),
    :func:`_plain_attention` (``use_flash=False``), or, by default, the
    kernels for CUDA tensors and the plain core for CPU tensors, as the
    reference takes its kernel whenever it runs on the accelerator. On a
    CUDA tensor the kernels run or raise (a dtype or head dim they were
    not built for); nothing falls back. The config's window applies
    either way."""
    window = cfg.attn_window
    if mesh is not None and mesh.shape["sp"] > 1:
        group = mesh.group("sp")

        def ring(q, k, v, causal=True, segment_ids=None):
            return ring_attention(q, k, v, group=group, causal=causal,
                                  window=window, segment_ids=segment_ids)

        return ring
    plain = _plain_attention(window)
    if use_flash is False:
        return plain

    def flash(q, k, v, causal=True, segment_ids=None):
        # The model checked the segment order once for the batch.
        return _attend(q, k, v, causal, window, segment_ids)

    if use_flash:
        return flash

    def auto(q, k, v, causal=True, segment_ids=None):
        return (flash if q.is_cuda else plain)(q, k, v, causal=causal,
                                               segment_ids=segment_ids)

    return auto


def build_lm(cfg: LMConfig, mesh=None,
             use_flash: bool | None = None) -> TransformerLM:
    """The LM with :func:`attention_core`'s core (the ring on an sp
    mesh). On a tp mesh the kernels see each rank's local heads; on a pp
    mesh pp is inert, as the reference's is outside its pipelined model:
    every pp rank holds the whole replica and steps the same rows."""
    check_tp_layout(cfg, mesh)
    return TransformerLM(cfg, attn_impl=attention_core(cfg, mesh, use_flash),
                         mesh=mesh)


def lm_loss(logits, tokens=None, segment_ids=None, *, targets=None,
            valid=None, count=None):
    """Next-token cross entropy in f32: every position predicts its
    target (``ops.cross_entropy.next_token_targets`` of ``tokens`` and
    ``segment_ids``: the next token of its own document; packed
    batches' cross-document positions and each row's last are left
    out) and the loss is ``masked_mean`` over ``count``, by default the
    batch's own.

    A sequence shard passes ``targets`` and ``valid`` instead ((B, S),
    from the whole batch and sliced like ``logits``) and the whole
    batch's ``count``; ``tokens`` and ``segment_ids`` are then not
    read."""
    if targets is None:
        targets, valid = next_token_targets(tokens, segment_ids)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                         targets.reshape(-1).long(), reduction="none")
    return masked_mean(ce, valid.reshape(-1), count)


def create_lm_state(model: TransformerLM, seed: int = 0, tx=None,
                    device=None, mesh=None):
    """TrainState for the LM: f32 parameters from ``init_params`` with a
    seeded generator, on the card unless ``device="cpu"``, and AdamW by
    default, as the reference's ``optax.adamw(3e-4, weight_decay=0.01,
    mu_dtype=bfloat16)``.

    With a ``mesh`` (the model's, ``build_lm(cfg, mesh)``) the state is
    initialised whole from the same seed in host memory, then each rank
    moves only its shard of every leaf to the mesh's device, at
    ``param_sharding(..., tp_rules=LM_TP_RULES)``, the optimizer moments
    at their parameter's placement; ``state.placements`` records them
    (``shard_state``)."""
    tx = tx or AdamW(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
    if mesh is not None:
        if model.mesh is not mesh:
            raise ValueError("create_lm_state(mesh=) needs the model built "
                             "on that mesh: build_lm(cfg, mesh)")
        device = "cpu"
    params = trainable(init_params(model.cfg, seed=seed,
                                   device=resolve_device(device),
                                   dtype=torch.float32))
    state = TrainState(step=0, params=params, opt_state=tx.init(params),
                       tx=tx, apply_fn=model)
    if mesh is None:
        return state
    from kubeflow_tpu_torch.models.convert import shard_state

    return shard_state(state, mesh, apply_fn=model)


# The "auto" loss crossover of the reference (a sequence length): the
# fused vocab-tiled loss from here up, the dense one below.
AUTO_FUSED_MIN_SEQ = 8192


def _fused(cfg: LMConfig, seq: int) -> bool:
    return cfg.loss_impl == "fused" or (
        cfg.loss_impl == "auto" and seq >= AUTO_FUSED_MIN_SEQ)


def moe_aux_total(intermediates: dict[str, dict]):
    """The sum of the sowed ``moe_aux`` values ONLY: the diagnostics
    (``moe_expert_load``, ``moe_slot_max``) never reach the loss."""
    return sum(sown["moe_aux"] for sown in intermediates.values()
               if "moe_aux" in sown)


# The axes that split an LM batch: rows over (dp, fsdp), columns over sp.
LM_DATA_AXES = ("dp", "fsdp", "sp")


def make_lm_train_step(mesh=None, moe_aux_weight: float | None = None,
                       cfg: LMConfig | None = None):
    """The LM step: ``step(state, batch)`` with batch = {"tokens": (B, S)
    int, optional "segment_ids": (B, S)} computes the loss and its
    gradients, applies the optimizer IN PLACE under ``torch.no_grad``
    (the reference donates its state) and returns ``(state, {"loss":
    0-d tensor})``. The loss is ``lm_loss`` on the logits, or, with
    ``cfg.loss_impl == "fused"`` (or ``"auto"`` at sequences of
    ``AUTO_FUSED_MIN_SEQ`` and more), ``fused_lm_loss`` on the hidden
    states against the tied embedding in tiles of ``cfg.ce_block``
    rows, as the reference dispatches. For an MoE model (the state's
    ``apply_fn`` config) the loss adds ``moe_aux_weight`` times the sum
    of the blocks' ``moe_aux``: the weight is ``cfg.moe_aux_weight``
    unless given here, and the LMConfig default with neither.

    With a ``mesh`` the state must be on it (``create_lm_state(mesh=)``
    or ``shard_state``) and every rank passes the WHOLE batch, as the
    reference's step takes a global array. The step keeps this rank's
    (dp, fsdp) rows and sp columns and runs the collectives by hand:

    - the loss's targets and valid mask come from the whole batch
      (``next_token_targets``): a shard's last position predicts the
      first token of the next sp shard, and the globally last position
      predicts nothing; each rank's loss is its positions' NLL sum over
      the WHOLE batch's count, so the ranks' losses sum to the global
      mean (reported all-reduced over dp, fsdp and sp);
    - fsdp: the model all-gathers the embedding once and each block's
      sharded leaves as the block runs, again in its backward, where
      their gradients are reduce-scattered (``parallel.fsdp``); the
      embedding's gradient is reduce-scattered at the backward's end;
    - tp: Megatron's conjugate pair inside each block
      (:class:`TensorParallel`);
    - MoE: :class:`ExpertParallel` (experts on ep, routing over the
      whole sequence, the aux's means over the whole batch); the loss
      counts the aux once;
    - dp and sp (and fsdp for leaves it does not shard): after the
      backward the gradients are all-reduced over the axes that split
      the batch and the sequence (:func:`gradient_axes`), never over tp
      or ep, where the conjugate pairs already made the replicated
      leaves' gradients whole and equal, and the MoE leaves' never over
      sp, which their layer made whole and equal the same way;
    - AdamW then runs on each rank's shards.

    The collectives inside the backward (tp's, the ring's, the MoE
    layer's and fsdp's) run in the reverse of the forward's order on
    every rank, ranks whose ring skips other hops included
    (``parallel.fsdp``); the remaining reductions come after it, in the
    parameters' order. Meshless, the same step runs on the whole batch
    with no collective.

    The step runs under ``obs.profile.span`` ranges that a trace reads:
    ``train.step`` around it all, ``train.forward`` through the loss,
    ``train.backward`` around the gradients (and their reductions on a
    mesh), ``train.optimizer`` around AdamW and what follows it, as
    ``make_train_step``'s."""
    loss_cfg = cfg or LMConfig()
    if moe_aux_weight is None:
        moe_aux_weight = loss_cfg.moe_aux_weight

    def step(state, batch):
        with span("train.step"):
            return _step(state, batch)

    def _step(state, batch):
        model = state.apply_fn
        if getattr(model, "mesh", None) is not mesh:
            raise ValueError("the state is not on this mesh: "
                             "create_lm_state(model, mesh=mesh) or "
                             "shard_state(state, mesh)")
        if mesh is not None and state.placements["params"] != model.placements:
            raise ValueError("the state's placements are not its model's "
                             "layout (LM_TP_RULES): lay it out with "
                             "shard_state(state, mesh)")
        with span("train.forward"):
            tokens, seg = batch["tokens"], batch.get("segment_ids")
            targets, valid = next_token_targets(tokens, seg)
            rows = cols = slice(None)
            emb = state.params["embed"]["embedding"]
            if mesh is not None:
                rows = mesh.slice(("dp", "fsdp"), tokens.shape[0])
                cols = mesh.slice("sp", tokens.shape[1])
                seg = None if seg is None else seg[rows]
                emb = model.embedding(state.params)
            shard = {"targets": targets[rows, cols],
                     "valid": valid[rows, cols],
                     "count": valid.sum().clamp_min(1.0)}
            fused = _fused(loss_cfg, tokens.shape[1])
            moe = getattr(getattr(model, "cfg", None), "moe_experts", 0)
            out, intermediates = model(state.params, tokens[rows], seg,
                                       return_hidden=fused,
                                       return_intermediates=True,
                                       embedding=emb,
                                       split_rows=mesh is not None)
            if fused:
                ce = fused_lm_loss(out, emb, block=loss_cfg.ce_block,
                                   **shard)
            else:
                ce = lm_loss(out, **shard)
            loss, aux = ce, None
            if moe:
                aux = moe_aux_weight * moe_aux_total(intermediates)
                loss = ce + aux
        with span("train.backward"):
            paths = [path for path, _ in flatten(state.params)]
            grads = torch.autograd.grad(
                loss, [t for _, t in flatten(state.params)])
            if mesh is not None:
                grads = reduce_gradients(mesh, grads, [
                    gradient_axes(model.placements[p], LM_DATA_AXES,
                                  whole_over_sp="/moe/" in p) for p in paths])
        with span("train.optimizer"):
            with torch.no_grad():
                state.tx.update(grads, state.opt_state, state.params)
            loss = loss.detach()
            if mesh is not None:
                # The aux is already the whole batch's on every rank.
                loss = all_reduce(ce.detach().clone(),
                                  mesh.group(LM_DATA_AXES))
                if aux is not None:   # a float 0 under expert choice
                    loss = loss + (aux.detach() if torch.is_tensor(aux)
                                   else aux)
            state.step += 1
        return state, {"loss": loss}

    return step


__all__ = ["LMConfig", "TransformerLM", "Block", "rms_norm", "tied_head",
           "gelu", "init_params", "param_count", "train_flops_per_sequence",
           "build_lm", "lm_loss",
           "create_lm_state", "make_lm_train_step", "AUTO_FUSED_MIN_SEQ",
           "is_moe_block", "moe_ffn", "moe_aux_total", "LM_TP_RULES",
           "check_tp_layout", "lm_placements", "TensorParallel",
           "attention_core"]

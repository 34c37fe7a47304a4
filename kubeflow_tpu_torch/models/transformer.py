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
import torch.nn.functional as F

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models.optim import AdamW, flatten, trainable
from kubeflow_tpu_torch.models.train import TrainState
from kubeflow_tpu_torch.ops.attention import (
    _attend,
    apply_rope,
    check_segment_ids,
    mha_reference,
)
from kubeflow_tpu_torch.ops.cross_entropy import fused_lm_loss

AttnImpl = Callable[..., torch.Tensor]  # (q, k, v, causal=, segment_ids=)


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


def _topk_routing(cfg: LMConfig, probs, cap: int, sow: dict | None):
    """Tokens choose experts (Switch k=1, GShard k=2;
    :func:`_topk_choices`), each choice's gate its probability; with k > 1
    the selected gates are renormalised (Mixtral). Choice order is priority
    order (GShard): every first choice claims a slot of its expert's
    ``cap`` before any second choice, and an assignment past the capacity
    is dropped (the token falls through the residual). Returns the
    (B, S, E, C) f32 dispatch and combine tensors.

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
        # Load-balance aux (Switch eq. 4 over first choices): fraction of
        # tokens times fraction of router mass, per expert.
        sow["moe_aux"] = e * (onehots[0].mean(dim=(0, 1))
                              * probs.mean(dim=(0, 1))).sum()
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
              sow: dict | None = None):
    """The router of one block's ``moe`` params over x (B, S, D), in f32
    (its softmax too), and the configured routing: the (B, S, E, C) f32
    dispatch and combine tensors. ``sow`` receives ``moe_aux`` (top-k
    only), ``moe_expert_load`` (E,) and ``moe_slot_max``."""
    cap = _moe_capacity(cfg, x.shape[1])
    probs = torch.softmax(x.float() @ p["router"]["kernel"].float(), dim=-1)
    if cfg.moe_router == "expert_choice":
        dispatch_t, combine_t = _expert_choice_routing(probs, cap)
    else:
        dispatch_t, combine_t = _topk_routing(cfg, probs, cap, sow)
    if sow is not None:
        with torch.no_grad():
            sow["moe_expert_load"] = dispatch_t.sum(dim=(0, 1, 3))
            sow["moe_slot_max"] = dispatch_t.sum(dim=1).max()
    return dispatch_t, combine_t


def moe_dispatch(cfg: LMConfig, x, dispatch_t):
    """Tokens to the expert-major layout: (E, B, C, D) in ``cfg.dtype``."""
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


def moe_combine(cfg: LMConfig, combine_t, expert_out):
    """The experts' outputs back to (B, S, D), weighted by the combine
    tensor rounded to ``cfg.dtype`` as the reference casts it."""
    dt = cfg.dtype
    return torch.einsum("bsec,ebcd->bsd", combine_t.to(dt).float(),
                        expert_out.float()).to(dt)


def moe_ffn(cfg: LMConfig, p: dict[str, Any], x,
            sow: dict | None = None) -> torch.Tensor:
    """The reference's ``MoEFFN`` over one block's ``moe`` params: (B, S,
    D) -> (B, S, D). The router runs in f32; dispatch, the experts and
    the combine are dense products in ``cfg.dtype`` with f32
    accumulation (:func:`moe_route`, :func:`moe_dispatch`,
    :func:`moe_experts`, :func:`moe_combine`)."""
    dispatch_t, combine_t = moe_route(cfg, p, x, sow)
    expert_out = moe_experts(cfg, p, moe_dispatch(cfg, x, dispatch_t))
    return moe_combine(cfg, combine_t, expert_out)


def init_params(cfg: LMConfig, seed: int = 0, device=None,
                dtype=torch.float32) -> dict[str, Any]:
    """Seeded random parameters in the reference's names and layouts:
    Dense kernels ~ N(0, 1/fan_in) (lecun normal, untruncated), the
    embedding ~ N(0, 1/dim), norm scales 1; an MoE block's router in f32
    and its expert weights with fan-in counted over (E, in), as flax's
    lecun normal counts it for a 3-d kernel. Drawn on the CPU from one
    ``torch.Generator`` (the same numbers on every device), then moved."""
    gen = torch.Generator().manual_seed(int(seed))

    def normal(shape, std):
        return (torch.randn(shape, generator=gen) * std).to(
            device=device, dtype=dtype)

    def ones(n):
        return torch.ones(n, device=device, dtype=torch.float32)

    d, hd = cfg.dim, cfg.head_dim
    kv = cfg.num_kv_heads * hd
    hidden = cfg.mlp_ratio * d
    params: dict[str, Any] = {
        "embed": {"embedding": normal((cfg.vocab, d), d ** -0.5)}}
    e = cfg.moe_experts
    for i in range(cfg.layers):
        blk = {
            "RMSNorm_0": {"scale": ones(d)},
            "q_proj": {"kernel": normal((d, d), d ** -0.5)},
            "k_proj": {"kernel": normal((d, kv), d ** -0.5)},
            "v_proj": {"kernel": normal((d, kv), d ** -0.5)},
            "proj": {"kernel": normal((d, d), d ** -0.5)},
            "RMSNorm_1": {"scale": ones(d)},
        }
        if is_moe_block(cfg, i):
            blk["moe"] = {
                "router": {"kernel": (torch.randn((d, e), generator=gen)
                                      * d ** -0.5).to(device=device)},
                "experts_up": normal((e, d, hidden), (e * d) ** -0.5),
                "experts_down": normal((e, hidden, d), (e * hidden) ** -0.5),
            }
        else:
            blk["up"] = {"kernel": normal((d, hidden), d ** -0.5)}
            blk["down"] = {"kernel": normal((hidden, d), hidden ** -0.5)}
        params[f"block_{i}"] = blk
    params["final_norm"] = {"scale": ones(d)}
    return params


def param_count(params: dict[str, Any]) -> int:
    total = 0
    for value in params.values():
        if isinstance(value, dict):
            total += param_count(value)
        elif isinstance(value, torch.Tensor):
            total += value.numel()
    return total


def _plain_attention(window: int | None) -> AttnImpl:
    """The plain attention core: :func:`mha_reference` in f32 with the
    config's window, the reference's core off the accelerator."""
    def plain(q, k, v, causal=True, segment_ids=None):
        return mha_reference(q, k, v, causal=causal, window=window,
                             segment_ids=segment_ids)
    return plain


class Block:
    """Pre-norm block: attention (GQA, RoPE, causal) + dense tanh-GELU
    FFN, or the MoE layer (``use_moe``), applied to one ``block_<i>``
    parameter dict. ``attn_impl`` is the attention core; without one,
    :func:`_plain_attention`. ``sow`` receives the MoE intermediates."""

    def __init__(self, cfg: LMConfig, attn_impl: AttnImpl | None = None):
        self.cfg = cfg
        self.attn_impl = attn_impl or _plain_attention(cfg.attn_window)

    def __call__(self, p: dict[str, Any], x, segment_ids=None,
                 use_moe: bool = False, sow: dict | None = None):
        cfg = self.cfg
        b, s, _ = x.shape
        h = rms_norm(p["RMSNorm_0"]["scale"], x)
        q = _dense(h, p["q_proj"]["kernel"], cfg.dtype)
        k = _dense(h, p["k_proj"]["kernel"], cfg.dtype)
        v = _dense(h, p["v_proj"]["kernel"], cfg.dtype)

        def heads(t, n):
            return t.reshape(b, s, n, cfg.head_dim).transpose(1, 2)

        q = apply_rope(heads(q, cfg.heads))
        k = apply_rope(heads(k, cfg.num_kv_heads))
        v = heads(v, cfg.num_kv_heads)
        out = self.attn_impl(q, k, v, causal=True, segment_ids=segment_ids)
        out = out.transpose(1, 2).reshape(b, s, cfg.dim)
        x = x + _dense(out, p["proj"]["kernel"], cfg.dtype)
        h = rms_norm(p["RMSNorm_1"]["scale"], x)
        if use_moe:
            return x + moe_ffn(cfg, p["moe"], h, sow)
        h = gelu(_dense(h, p["up"]["kernel"], cfg.dtype))
        return x + _dense(h, p["down"]["kernel"], cfg.dtype)


class TransformerLM:
    """The full-sequence forward over a parameter dict in the reference
    layout: ``model(params, tokens)``, (B, S) tokens -> (B, S, vocab) f32
    logits (or the post-norm hidden states with ``return_hidden``).
    ``segment_ids`` (B, S) masks attention to each packed document; their
    order is checked once here, not in every layer.
    ``return_intermediates`` also returns what the MoE blocks sow (the
    reference's ``mutable=["intermediates"]``): ``{"block_<i>":
    {"moe_aux", "moe_expert_load", "moe_slot_max"}}``, ``moe_aux`` for
    top-k routing only; empty for a dense model."""

    def __init__(self, cfg: LMConfig, attn_impl: AttnImpl | None = None):
        self.cfg = cfg
        self.block = Block(cfg, attn_impl)

    def __call__(self, params: dict[str, Any], tokens, segment_ids=None,
                 return_hidden=False, return_intermediates=False):
        cfg = self.cfg
        if segment_ids is not None:
            check_segment_ids(segment_ids)
        emb = params["embed"]["embedding"]
        x = emb[tokens].to(cfg.dtype)
        intermediates: dict[str, dict] = {}
        for i in range(cfg.layers):
            use_moe = is_moe_block(cfg, i)
            sow = None
            if use_moe and return_intermediates:
                sow = intermediates.setdefault(f"block_{i}", {})
            x = self.block(params[f"block_{i}"], x, segment_ids,
                           use_moe=use_moe, sow=sow)
        x = rms_norm(params["final_norm"]["scale"], x)
        out = x if return_hidden else tied_head(x, emb, cfg.dtype)
        return (out, intermediates) if return_intermediates else out


def build_lm(cfg: LMConfig, mesh=None,
             use_flash: bool | None = None) -> TransformerLM:
    """Pick the attention core: the flash kernels (``use_flash=True``;
    their plain twins on CPU tensors), :func:`_plain_attention`
    (``use_flash=False``), or, by default, the kernels for CUDA tensors
    and the plain core for CPU tensors, as the reference takes its
    kernel whenever it runs on the accelerator. On a CUDA tensor the
    kernels run or raise (a dtype or head dim they were not built for);
    nothing falls back. The config's window applies either way."""
    if mesh is not None:
        raise NotImplementedError(
            "meshes (ring attention, tp/fsdp) belong to the parallel/ "
            "slice of the port (ROADMAP A10)")
    if use_flash is False:
        return TransformerLM(cfg)
    window = cfg.attn_window

    def flash(q, k, v, causal=True, segment_ids=None):
        # TransformerLM checked the segment order once for the batch.
        return _attend(q, k, v, causal, window, segment_ids)

    if use_flash:
        return TransformerLM(cfg, attn_impl=flash)
    plain = _plain_attention(window)

    def auto(q, k, v, causal=True, segment_ids=None):
        return (flash if q.is_cuda else plain)(q, k, v, causal=causal,
                                               segment_ids=segment_ids)

    return TransformerLM(cfg, attn_impl=auto)


def lm_loss(logits, tokens, segment_ids=None):
    """Next-token cross entropy in f32: predict tokens[:, 1:] from
    logits[:, :-1]. With ``segment_ids`` (packed batches), positions
    whose target falls in a different document are excluded."""
    vocab = logits.shape[-1]
    ce = F.cross_entropy(logits[:, :-1].reshape(-1, vocab).float(),
                         tokens[:, 1:].reshape(-1).long(),
                         reduction="none").reshape(tokens.shape[0], -1)
    if segment_ids is None:
        return ce.mean()
    valid = (segment_ids[:, 1:] == segment_ids[:, :-1]).to(ce.dtype)
    return (ce * valid).sum() / valid.sum().clamp_min(1.0)


def create_lm_state(model: TransformerLM, seed: int = 0, tx=None,
                    device=None):
    """TrainState for the LM: f32 parameters from ``init_params`` with a
    seeded generator, on the card unless ``device="cpu"``, and AdamW by
    default, as the reference's ``optax.adamw(3e-4, weight_decay=0.01,
    mu_dtype=bfloat16)``."""
    tx = tx or AdamW(3e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
    params = trainable(init_params(model.cfg, seed=seed,
                                   device=resolve_device(device),
                                   dtype=torch.float32))
    return TrainState(step=0, params=params, opt_state=tx.init(params),
                      tx=tx, apply_fn=model)


# The "auto" loss crossover of the reference (a sequence length): the
# fused vocab-tiled loss from here up, the dense one below.
AUTO_FUSED_MIN_SEQ = 8192


def moe_aux_total(intermediates: dict[str, dict]):
    """The sum of the sowed ``moe_aux`` values ONLY: the diagnostics
    (``moe_expert_load``, ``moe_slot_max``) never reach the loss."""
    return sum(sown["moe_aux"] for sown in intermediates.values()
               if "moe_aux" in sown)


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
    unless given here, and the LMConfig default with neither."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded training belongs to the parallel/ slice of the port "
            "(ROADMAP A10)")
    loss_cfg = cfg or LMConfig()
    if moe_aux_weight is None:
        moe_aux_weight = loss_cfg.moe_aux_weight

    def step(state, batch):
        tokens = batch["tokens"]
        seg = batch.get("segment_ids")
        fused = loss_cfg.loss_impl == "fused" or (
            loss_cfg.loss_impl == "auto"
            and tokens.shape[1] >= AUTO_FUSED_MIN_SEQ)
        moe = getattr(getattr(state.apply_fn, "cfg", None), "moe_experts", 0)
        leaves = [t for _, t in flatten(state.params)]
        out = state.apply_fn(state.params, tokens, seg, return_hidden=fused,
                             **({"return_intermediates": True} if moe
                                else {}))
        out, intermediates = out if moe else (out, {})
        if fused:
            loss = fused_lm_loss(out, state.params["embed"]["embedding"],
                                 tokens, seg, block=loss_cfg.ce_block)
        else:
            loss = lm_loss(out, tokens, seg)
        if moe:
            loss = loss + moe_aux_weight * moe_aux_total(intermediates)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            state.tx.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, {"loss": loss.detach()}

    return step


__all__ = ["LMConfig", "TransformerLM", "Block", "rms_norm", "tied_head",
           "gelu", "init_params", "param_count", "build_lm", "lm_loss",
           "create_lm_state", "make_lm_train_step", "AUTO_FUSED_MIN_SEQ",
           "is_moe_block", "moe_ffn", "moe_aux_total"]

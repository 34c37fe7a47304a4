"""The models of the PyTorch port: the LM's config, forward (MoE blocks
included), losses (dense, and the vocab-tiled fused loss from
``ops/cross_entropy``, plus the MoE aux term) and train step
(``transformer``); ResNet-18/50 (``resnet``); AdamW with a
bf16 first moment and ``make_optimizer``'s Nesterov SGD (``optim``); the
train state, ResNet's train and eval steps and the loops, the
checkpointed one included (``train``); the checkpoint store in the
reference's on-disk format (``checkpoint``); the flax weight and
train-state converter (``convert``); KV-cache decode with stacked params
and rolling chunks (``decoding``), the continuous batcher with its
speculative verify (``serving``) and self-speculative n-gram decoding
(``speculative``). The LM and image steps train on dp/fsdp/tp/sp/ep
meshes (``parallel``), and the pipelined LM over pp (``pipeline_lm``)."""

from kubeflow_tpu_torch.models.convert import (
    gather_state,
    params_from_jax,
    resnet_variables_from_jax,
    shard_state,
    train_state_from_jax,
)
from kubeflow_tpu_torch.models.decoding import (
    Int8Linear,
    KVCache,
    StackedDecodeParams,
    forward_with_cache,
    generate,
    quantize_decode_params,
    stack_decode_params,
)
from kubeflow_tpu_torch.models.optim import (
    AdamW,
    AdamWState,
    NesterovSGD,
    make_optimizer,
)
from kubeflow_tpu_torch.models.pipeline_lm import (
    PipelinedLM,
    create_pp_lm_state,
    make_pp_lm_train_step,
    pp_param_sharding,
)
from kubeflow_tpu_torch.models.resnet import (
    ResNet,
    resnet18,
    resnet50,
    resnet_flops_per_image,
)
from kubeflow_tpu_torch.models.serving import BatchState, ContinuousBatcher
from kubeflow_tpu_torch.models.speculative import (
    NGramProposer,
    SpecStats,
    speculative_generate,
)
from kubeflow_tpu_torch.models.train import (
    RunReport,
    TrainState,
    create_train_state,
    cross_entropy,
    make_eval_step,
    make_train_step,
    realign_batches,
    run_steps,
    run_with_checkpointing,
    state_shardings,
)
from kubeflow_tpu_torch.models.transformer import (
    LM_TP_RULES,
    LMConfig,
    TransformerLM,
    build_lm,
    check_tp_layout,
    create_lm_state,
    init_params,
    lm_loss,
    make_lm_train_step,
)

__all__ = [
    "LMConfig",
    "TransformerLM",
    "build_lm",
    "init_params",
    "lm_loss",
    "create_lm_state",
    "make_lm_train_step",
    "LM_TP_RULES",
    "check_tp_layout",
    "TrainState",
    "run_steps",
    "RunReport",
    "realign_batches",
    "run_with_checkpointing",
    "AdamW",
    "AdamWState",
    "NesterovSGD",
    "make_optimizer",
    "ResNet",
    "resnet18",
    "resnet50",
    "resnet_flops_per_image",
    "create_train_state",
    "cross_entropy",
    "make_train_step",
    "make_eval_step",
    "state_shardings",
    "shard_state",
    "gather_state",
    "params_from_jax",
    "resnet_variables_from_jax",
    "train_state_from_jax",
    "Int8Linear",
    "KVCache",
    "forward_with_cache",
    "generate",
    "quantize_decode_params",
    "StackedDecodeParams",
    "stack_decode_params",
    "ContinuousBatcher",
    "BatchState",
    "NGramProposer",
    "SpecStats",
    "speculative_generate",
    "PipelinedLM",
    "pp_param_sharding",
    "create_pp_lm_state",
    "make_pp_lm_train_step",
]

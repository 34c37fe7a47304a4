"""The LM of the PyTorch port: config, forward, loss and train step
(``transformer``), AdamW with a bf16 first moment (``optim``), the train
state and loops, the checkpointed one included (``train``), the
checkpoint store in the reference's on-disk format (``checkpoint``), the
flax weight and train-state converter (``convert``), KV-cache decode
with stacked params and rolling chunks (``decoding``) and the continuous
batcher (``serving``). ResNet, the fused cross-entropy, pipelining and
speculative decoding belong to later slices."""

from kubeflow_tpu_torch.models.convert import (
    params_from_jax,
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
from kubeflow_tpu_torch.models.optim import AdamW, AdamWState
from kubeflow_tpu_torch.models.serving import BatchState, ContinuousBatcher
from kubeflow_tpu_torch.models.train import (
    RunReport,
    TrainState,
    realign_batches,
    run_steps,
    run_with_checkpointing,
)
from kubeflow_tpu_torch.models.transformer import (
    LMConfig,
    TransformerLM,
    build_lm,
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
    "TrainState",
    "run_steps",
    "RunReport",
    "realign_batches",
    "run_with_checkpointing",
    "AdamW",
    "AdamWState",
    "params_from_jax",
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
]

"""The LM of the PyTorch port: config, forward, loss and train step
(``transformer``), AdamW with a bf16 first moment (``optim``), the train
state and loop (``train``), the flax weight and train-state converter
(``convert``), KV-cache decode (``decoding``) and the continuous batcher
(``serving``). ResNet, the fused cross-entropy, checkpointing,
pipelining and speculative decoding belong to later slices."""

from kubeflow_tpu_torch.models.convert import (
    params_from_jax,
    train_state_from_jax,
)
from kubeflow_tpu_torch.models.decoding import (
    Int8Linear,
    KVCache,
    forward_with_cache,
    generate,
    quantize_decode_params,
)
from kubeflow_tpu_torch.models.optim import AdamW, AdamWState
from kubeflow_tpu_torch.models.serving import BatchState, ContinuousBatcher
from kubeflow_tpu_torch.models.train import TrainState, run_steps
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
    "AdamW",
    "AdamWState",
    "params_from_jax",
    "train_state_from_jax",
    "Int8Linear",
    "KVCache",
    "forward_with_cache",
    "generate",
    "quantize_decode_params",
    "ContinuousBatcher",
    "BatchState",
]

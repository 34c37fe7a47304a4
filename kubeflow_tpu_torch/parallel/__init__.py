"""Device-mesh parallelism for the port: the process group from the
platform env (``distributed``), named meshes and placements (``mesh``),
the hand-written collectives the sharded models run (``collectives``),
fsdp's per-block gathers (``fsdp``) and the pipeline schedules over
``pp`` (``pipeline``, with the interleaved 1F1B tables of
``schedule1f1b``)."""

from kubeflow_tpu_torch.parallel.distributed import (
    DistributedEnv,
    initialize_from_env,
    slice_env_for_rank,
)
from kubeflow_tpu_torch.parallel.pipeline import (
    gpipe,
    interleaved_gpipe,
    interleaved_one_f_one_b,
    one_f_one_b,
    pipeline_ticks,
    stage_stack,
    stage_stack_interleaved,
)
from kubeflow_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    MeshSpec,
    Sharding,
    auto_mesh,
    batch_sharding,
    gather_block,
    local_block,
    make_mesh,
    make_multislice_mesh,
    param_sharding,
    replicated,
    token_sharding,
)

__all__ = [
    "AXES",
    "Mesh",
    "MeshSpec",
    "Sharding",
    "make_mesh",
    "make_multislice_mesh",
    "auto_mesh",
    "batch_sharding",
    "token_sharding",
    "replicated",
    "param_sharding",
    "local_block",
    "gather_block",
    "DistributedEnv",
    "initialize_from_env",
    "slice_env_for_rank",
    "gpipe",
    "one_f_one_b",
    "interleaved_gpipe",
    "interleaved_one_f_one_b",
    "pipeline_ticks",
    "stage_stack",
    "stage_stack_interleaved",
]

"""Device-mesh parallelism for the port: the process group from the
platform env (``distributed``), named meshes and placements (``mesh``)
and the hand-written collectives the sharded models run
(``collectives``). Pipelines (``pp``) belong to a later slice."""

from kubeflow_tpu_torch.parallel.distributed import (
    DistributedEnv,
    initialize_from_env,
    slice_env_for_rank,
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
]

"""The process group from the platform-injected environment.

The counterpart of ``kubeflow_tpu/parallel/distributed.py``. The platform
(notebook controller + PodDefault webhook) injects these env vars into
every replica of a multi-host notebook StatefulSet:

- ``TPU_WORKER_ID``        — pod ordinal (rank), 0..N-1
- ``TPU_WORKER_HOSTNAMES`` — comma-separated stable DNS names of all
                             replicas (headless Service)
- ``KFT_COORDINATOR_ADDRESS`` — ``<name>-0.<svc>.<ns>.svc:8476`` (rank 0)
- ``KFT_NUM_PROCESSES``    — replica count (hosts in the slice)

:class:`DistributedEnv` and :func:`slice_env_for_rank` are the port's own
copies of the reference's (framework-free, but the port imports nothing
of the JAX package). :func:`initialize_from_env` forms the
``torch.distributed`` world from that env.

**Processes.** JAX runs one process per host that sees every local chip;
PyTorch runs one process per GPU. The two map explicitly: when torchrun
(or any launcher) sets ``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK`` in a pod,
the pod holds that many processes and

    global rank = TPU_WORKER_ID x LOCAL_WORLD_SIZE + LOCAL_RANK,
    world size  = KFT_NUM_PROCESSES x LOCAL_WORLD_SIZE;

otherwise each pod is one process (rank ``TPU_WORKER_ID``, world size
``KFT_NUM_PROCESSES``). Every process rendezvouses at the coordinator's
``host:port``, which rank 0's TCP store listens on.
"""

from __future__ import annotations

import dataclasses
import logging
import os

log = logging.getLogger(__name__)

COORDINATOR_PORT = 8476

ENV_WORKER_ID = "TPU_WORKER_ID"
ENV_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_COORDINATOR = "KFT_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "KFT_NUM_PROCESSES"
# JAX-native name the image's 10-tpu-env script derives for pods booted
# WITHOUT the webhook (ordinal path); from_env falls back to it.
ENV_JAX_COORDINATOR = "JAX_COORDINATOR_ADDRESS"
# Set by torchrun for each of a pod's processes (one per GPU).
ENV_LOCAL_RANK = "LOCAL_RANK"
ENV_LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"


@dataclasses.dataclass(frozen=True)
class DistributedEnv:
    """Parsed view of the platform-injected distributed environment."""

    process_id: int = 0
    num_processes: int = 1
    coordinator_address: str | None = None
    worker_hostnames: tuple[str, ...] = ()

    @property
    def is_multihost(self) -> bool:
        return self.num_processes > 1

    @classmethod
    def from_env(cls, env: dict[str, str] | None = None) -> "DistributedEnv":
        env = os.environ if env is None else env
        hostnames = tuple(
            h for h in env.get(ENV_WORKER_HOSTNAMES, "").split(",") if h
        )
        num = int(env.get(ENV_NUM_PROCESSES, len(hostnames) or 1))
        # Precedence: webhook-injected KFT_COORDINATOR_ADDRESS, then the
        # JAX-native name the image's 10-tpu-env script derives for pods
        # spawned WITHOUT the webhook (ordinal-derivation path), then
        # rank 0 of the hostname list.
        coord = env.get(ENV_COORDINATOR) or env.get(ENV_JAX_COORDINATOR)
        if not coord and hostnames:
            coord = f"{hostnames[0]}:{COORDINATOR_PORT}"
        return cls(
            process_id=int(env.get(ENV_WORKER_ID, 0)),
            num_processes=num,
            coordinator_address=coord,
            worker_hostnames=hostnames,
        )


def process_rank(denv: DistributedEnv,
                 env: dict[str, str] | None = None) -> tuple[int, int, int]:
    """(global rank, world size, local rank) of this process under the
    mapping in the module docstring."""
    env = os.environ if env is None else env
    local_world = int(env.get(ENV_LOCAL_WORLD_SIZE, 1))
    local_rank = int(env.get(ENV_LOCAL_RANK, 0))
    if not 0 <= local_rank < local_world:
        raise ValueError(f"{ENV_LOCAL_RANK}={local_rank} outside "
                         f"{ENV_LOCAL_WORLD_SIZE}={local_world}")
    return (denv.process_id * local_world + local_rank,
            denv.num_processes * local_world, local_rank)


def initialize_from_env(env: dict[str, str] | None = None,
                        device=None) -> DistributedEnv:
    """Initialise ``torch.distributed`` from platform env; no-op for one
    process.

    Safe to call unconditionally at image startup: a single-replica
    notebook has no hostnames env and skips initialisation, so the same
    image runs single-host and multi-host. Otherwise the world is formed
    at ``tcp://<coordinator>``, rank and size as the module docstring
    maps them, with NCCL on the card (``device=None``: the process's
    GPU is ``LOCAL_RANK``) or gloo when the caller passes
    ``device="cpu"``. Without a card and without ``device="cpu"`` this
    raises, as every entry point of the port does.
    """
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch._device import resolve_device

    denv = DistributedEnv.from_env(env)
    rank, world, local_rank = process_rank(denv, env)
    if world == 1:
        log.info("single-process notebook: skipping torch.distributed")
        return denv
    if not denv.coordinator_address:
        raise ValueError(
            f"{world} processes but no coordinator address: set "
            f"{ENV_COORDINATOR} (or {ENV_WORKER_HOSTNAMES})")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{denv.coordinator_address}",
        world_size=world, rank=rank)
    log.info("torch.distributed up: rank %d/%d coordinator=%s backend=%s",
             rank, world, denv.coordinator_address, dist.get_backend())
    return denv


def slice_env_for_rank(
    name: str,
    namespace: str,
    rank: int,
    num_replicas: int,
    service: str | None = None,
) -> dict[str, str]:
    """The env block the platform injects for replica ``rank``.

    The same block as the reference's (the notebook controller's
    StatefulSet generator and the PodDefault webhook both produce it).
    The default ``service`` is the headless per-replica Service the
    controller creates (``<name>-hosts``); per-pod DNS only resolves
    under it.
    """
    service = service or f"{name}-hosts"
    hosts = ",".join(
        f"{name}-{i}.{service}.{namespace}.svc" for i in range(num_replicas)
    )
    env = {
        ENV_WORKER_ID: str(rank),
        ENV_NUM_PROCESSES: str(num_replicas),
    }
    if num_replicas > 1:
        env[ENV_WORKER_HOSTNAMES] = hosts
        env[ENV_COORDINATOR] = (
            f"{name}-0.{service}.{namespace}.svc:{COORDINATOR_PORT}"
        )
    return env

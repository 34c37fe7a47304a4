"""Named device meshes and canonical placements.

The counterpart of ``kubeflow_tpu/parallel/mesh.py``. Axis names are
fixed platform-wide so models, optimizers, and checkpoints agree:

- ``"dp"``   — data parallel (batch dimension; gradients all-reduced)
- ``"pp"``   — pipeline parallel (layer stages)
- ``"fsdp"`` — fully-sharded data parallel (params/opt-state sharded,
               all-gathered before use, gradients reduce-scattered)
- ``"tp"``   — tensor parallel (hidden/heads dimension, Megatron layout)
- ``"sp"``   — sequence/context parallel (ring attention)
- ``"ep"``   — expert parallel (MoE experts sharded)

A mesh here is one process per device: the world's ranks (or some of
them) laid row-major over :data:`AXES`, as the reference reshapes
``jax.devices()``, so rank *r* holds the block that JAX device *r*
holds. :class:`Mesh` keeps the process groups of each axis and of the
axis sets the train steps reduce over, and this rank's coordinates;
:class:`Sharding` is a placement on a mesh.

A placement is what the reference's ``PartitionSpec`` is: one entry per
dimension of an array, the mesh axis that shards it (or a tuple of axes,
row-major) or ``None``. :func:`param_sharding` reads only ``mesh.shape``,
so the layout rules run without a world. The collectives themselves are
written by hand where the models need them (``parallel/collectives``);
no DTensor reaches the kernels.
"""

from __future__ import annotations

import dataclasses
import math
import socket

import numpy as np

AXES = ("dp", "pp", "fsdp", "tp", "sp", "ep")
# Axis sets a train step reduces over, besides the single axes: the batch
# (dp, fsdp), and the batch with the sequence (dp, fsdp, sp; dp, sp).
GROUPED_AXES = (("dp", "fsdp"), ("dp", "sp"), ("dp", "fsdp", "sp"))

Placement = tuple


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism layout mapped onto the world's devices.

    Any axis left at 1 is inert. ``dp=-1`` means "absorb all remaining
    devices into data parallelism".
    """

    dp: int = -1
    pp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        fixed = self.pp * self.fsdp * self.tp * self.sp * self.ep
        dp = self.dp
        if dp == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"pp*fsdp*tp*sp*ep={fixed}"
                )
            dp = n_devices // fixed
        if dp * fixed != n_devices:
            raise ValueError(
                f"mesh {dp}x{self.pp}x{self.fsdp}x{self.tp}x{self.sp}"
                f"x{self.ep} != {n_devices} devices"
            )
        return MeshSpec(dp=dp, pp=self.pp, fsdp=self.fsdp, tp=self.tp,
                        sp=self.sp, ep=self.ep)

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.dp, self.pp, self.fsdp, self.tp, self.sp, self.ep)

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    def refactor(self, n_devices: int) -> "MeshSpec":
        """Deterministically re-factor a *resolved* spec onto a
        different device count, preserving axis semantics (elastic
        topology: a preemption leaves a smaller slice, or the queue frees
        a bigger one).

        Shrinking divides axes in the order **dp, then fsdp, then tp**;
        growing multiplies **dp only**. ``pp``/``sp``/``ep`` never
        change: they are model structure, not capacity.

        Raises ``ValueError`` when the spec is unresolved (``dp=-1``),
        when ``n_devices`` is not an integer multiple/divisor of the
        current size, or when a shrink cannot be absorbed by dp·fsdp·tp.
        """
        if self.dp == -1:
            raise ValueError("refactor() needs a resolved spec; call "
                             "resolve(n_devices) first")
        if n_devices < 1:
            raise ValueError(f"cannot refactor to {n_devices} devices")
        old = self.n_devices
        if n_devices == old:
            return self
        if n_devices > old:
            if n_devices % old:
                raise ValueError(
                    f"cannot grow {old} -> {n_devices} devices: not an "
                    "integer multiple"
                )
            return dataclasses.replace(self, dp=self.dp * (n_devices // old))
        if old % n_devices:
            raise ValueError(
                f"cannot shrink {old} -> {n_devices} devices: not an "
                "integer divisor"
            )
        factor = old // n_devices
        axes = {"dp": self.dp, "fsdp": self.fsdp, "tp": self.tp}
        for name in ("dp", "fsdp", "tp"):
            g = math.gcd(axes[name], factor)
            axes[name] //= g
            factor //= g
            if factor == 1:
                break
        if factor != 1:
            raise ValueError(
                f"cannot shrink {self} to {n_devices} devices: "
                f"dp*fsdp*tp cannot absorb a /{old // n_devices} "
                "(pp/sp/ep are fixed model structure)"
            )
        return dataclasses.replace(self, **axes)


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Ranks of the world as a named grid over :data:`AXES`.

    ``shape`` maps axis -> size (JAX's ``Mesh.shape``); ``coords`` this
    rank's index on each axis; ``rank`` its position in the grid (its
    world rank when the mesh spans the world); :meth:`group` the process
    group of an axis or of one of :data:`GROUPED_AXES` (its ranks
    row-major over the axes, so a group rank is :meth:`index` of those
    axes). A mesh needs no world to answer where blocks lie: the
    checkpoint's region reads and the tests build one from a spec and a
    rank alone (``groups`` then empty)."""

    axis_names = AXES

    def __init__(self, spec: MeshSpec, device, groups: dict, rank: int):
        self.spec = spec
        self.device = device
        self.shape = dict(zip(AXES, spec.shape))
        self.rank = rank
        self.coords = dict(zip(AXES, (int(c) for c in
                                      np.unravel_index(rank, spec.shape))))
        self._groups = groups

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (a name or a
        tuple), as a tuple entry of a placement numbers its blocks."""
        index = 0
        for a in _axes(axes):
            index = index * self.shape[a] + self.coords[a]
        return index

    def group(self, axes):
        return self._groups[_axes(axes)]

    def slice(self, axes, n: int) -> slice:
        """This rank's block of ``n`` items split evenly over ``axes``
        (a batch's rows over (dp, fsdp), a sequence over sp)."""
        parts = self.size(axes)
        if n % parts:
            raise ValueError(f"{n} does not divide over {_axes(axes)} "
                             f"({parts} blocks)")
        size = n // parts
        return slice(self.index(axes) * size, (self.index(axes) + 1) * size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def layout(spec: MeshSpec, world: int) -> np.ndarray:
    """The rank grid of ``spec`` over ``world`` ranks: row-major, as the
    reference reshapes its device list."""
    spec = spec.resolve(world)
    return np.arange(world).reshape(spec.shape)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(device):
    """The process group's device: form a world of one when there is no
    world yet (NCCL on the card, gloo for ``device="cpu"``), else take
    the existing world's (NCCL: this process's GPU; gloo: the CPU)."""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch._device import resolve_device

    if not dist.is_initialized():
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{_free_port()}",
            world_size=1, rank=0)
        return dev
    backend = dist.get_backend()
    dev = (resolve_device(None) if backend == "nccl"
           else torch.device("cpu"))
    if device is not None and resolve_device(device).type != dev.type:
        raise ValueError(f"the {backend} world runs on {dev.type}, not "
                         f"{device}")
    return dev


def make_mesh(spec: MeshSpec | None = None, device=None,
              ranks=None) -> Mesh | None:
    """Build a named mesh over the world's ranks, or over ``ranks`` (an
    ascending list of world ranks: the reference's ``devices``, as its
    ``make_mesh(spec, jax.devices()[:4])``).

    Without a world (one process, no ``initialize_from_env``) this forms
    a world of one itself, as the reference needs no distributed init on
    one host: NCCL on the card, gloo for ``device="cpu"``; without a
    card and without ``device="cpu"`` it raises. Every rank of the world
    must call it, in the same order as every other collective (each
    group is created by every rank); a rank outside ``ranks`` gets
    None."""
    import torch.distributed as dist

    dev = _world(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if ranks != sorted(set(ranks)) or not set(ranks) <= set(range(world)):
        raise ValueError(f"ranks {ranks} are not ascending ranks of a world "
                         f"of {world}")
    spec = (spec or MeshSpec()).resolve(len(ranks))
    grid = np.asarray(ranks).reshape(spec.shape)
    groups = {}
    for axes in [(a,) for a in AXES] + list(GROUPED_AXES):
        dims = [AXES.index(a) for a in axes]
        rest = [d for d in range(len(AXES)) if d not in dims]
        rows = grid.transpose(rest + dims).reshape(-1, math.prod(
            spec.shape[d] for d in dims))
        for row in rows:   # every rank creates every group, in one order
            pg = dist.new_group([int(r) for r in row])
            if rank in row:
                groups[axes] = pg
    if rank not in ranks:
        return None
    return Mesh(spec, dev, groups, ranks.index(rank))


def multislice_layout(spec: MeshSpec | None, num_slices: int,
                      world: int) -> np.ndarray:
    """The rank grid of a mesh spanning ``num_slices`` slices: only
    data parallelism may cross a slice boundary, and dp is laid out
    slice-major. Processes carry no slice index, so slices are
    contiguous chunks of ranks (the reference's fallback for devices
    without ``slice_index``), which the row-major layout already puts
    dp-major."""
    if num_slices > 1:
        if world % num_slices:
            raise ValueError(
                f"{world} devices not divisible by {num_slices} slices")
        dp = (spec or MeshSpec()).resolve(world).dp
        if dp % num_slices:
            raise ValueError(
                f"dp={dp} must be divisible by num_slices={num_slices}: "
                "only data parallelism may cross the DCN boundary")
    return layout(spec or MeshSpec(), world)


def make_multislice_mesh(spec: MeshSpec | None = None, num_slices: int = 1,
                         device=None) -> Mesh:
    """Mesh spanning multiple slices (:func:`multislice_layout`)."""
    import torch.distributed as dist

    _world(device)
    multislice_layout(spec, num_slices, dist.get_world_size())
    return make_mesh(spec, device)


def auto_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """Pure data-parallel mesh over the world (which must hold
    ``n_devices`` ranks when given: a process group has no subsets)."""
    import torch.distributed as dist

    _world(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"auto_mesh({n_devices}) in a world of {world}")
    return make_mesh(MeshSpec(dp=world), device)


def batch_sharding(mesh=None) -> Placement:
    """Shard the leading (batch) dim over dp+fsdp; replicate the rest."""
    return (("dp", "fsdp"),)


def token_sharding(mesh=None) -> Placement:
    """Canonical LM token layout: batch over (dp, fsdp), sequence over
    sp."""
    return (("dp", "fsdp"), "sp")


def replicated(mesh=None) -> Placement:
    return ()


def path_key(entry) -> str:
    """String key of one tree-path entry: a str as it is, or the
    ``key``/``name`` of a JAX path entry."""
    if isinstance(entry, str):
        return entry
    key = getattr(entry, "key", None)
    if key is None:
        key = getattr(entry, "name", None)
    return "" if key is None else str(key)


def _tp_kernel_dim(path: tuple, tp_rules: dict | None) -> int | None:
    """Which dim of a 2D Dense kernel shards over tp, per the MODEL's
    explicit rules ({module name -> dim}); generic models never get tp
    sharding by accident."""
    if not tp_rules or len(path) < 2 or path_key(path[-1]) != "kernel":
        return None
    return tp_rules.get(path_key(path[-2]))


def _is_expert_stack(path: tuple) -> bool:
    """True for MoE expert weight stacks: leaves whose final path key
    starts with ``experts_`` carry experts on dim 0."""
    return bool(path) and path_key(path[-1]).startswith("experts_")


def param_sharding(mesh, path: tuple, leaf, tp_rules: dict | None = None,
                   stage_axis: str | None = None) -> Placement:
    """Canonical parameter placement, the reference's rules: shard the
    largest dim that divides evenly over ``fsdp``; replicate small
    leaves (under 2**14 elements); the model's ``tp_rules`` place its
    projection kernels on tp with fsdp on the other dim; MoE expert
    stacks put experts on ``ep``; ``stage_axis`` marks a depth-stacked
    leaf (dim 0 on that axis).

    ``mesh`` is anything with a ``shape`` dict (a :class:`Mesh`, or the
    reference's mesh); ``leaf`` anything with a ``shape``. Returns one
    entry per dimension (``()`` for a replicated leaf, as ``P()``)."""
    shape = tuple(leaf.shape)
    if stage_axis is not None and shape:
        spec: list = [None] * len(shape)
        if shape[0] % mesh.shape[stage_axis] == 0:
            spec[0] = stage_axis
        tp = mesh.shape.get("tp", 1)
        if tp > 1:
            tp_dim = _tp_kernel_dim(path, tp_rules)
            # +1: the stage stack prepends the depth dim to the kernel.
            if tp_dim is not None and shape[tp_dim + 1] % tp == 0:
                spec[tp_dim + 1] = "tp"
        fsdp_n = mesh.shape["fsdp"]
        if fsdp_n > 1:
            for d in sorted(range(1, len(shape)), key=lambda d: -shape[d]):
                if spec[d] is None and shape[d] % fsdp_n == 0:
                    spec[d] = "fsdp"
                    break
        return tuple(spec)
    ep = mesh.shape.get("ep", 1)
    if ep > 1 and _is_expert_stack(path) and shape:
        if shape[0] % ep == 0:
            spec = [None] * len(shape)
            spec[0] = "ep"
            fsdp_n = mesh.shape["fsdp"]
            if fsdp_n > 1:
                for d in sorted(range(1, len(shape)),
                                key=lambda d: -shape[d]):
                    if shape[d] % fsdp_n == 0:
                        spec[d] = "fsdp"
                        break
            return tuple(spec)
    tp = mesh.shape.get("tp", 1)
    if tp > 1 and len(shape) == 2:
        tp_dim = _tp_kernel_dim(path, tp_rules)
        if tp_dim is not None and shape[tp_dim] % tp == 0:
            spec = [None, None]
            spec[tp_dim] = "tp"
            other = 1 - tp_dim
            if mesh.shape["fsdp"] > 1 and (
                    shape[other] % mesh.shape["fsdp"] == 0):
                spec[other] = "fsdp"
            return tuple(spec)
    fsdp = mesh.shape["fsdp"]
    if fsdp == 1 or not shape or math.prod(shape) < 2**14:
        return replicated()
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % fsdp == 0:
            spec = [None] * len(shape)
            spec[d] = "fsdp"
            return tuple(spec)
    return replicated()


class Sharding:
    """A placement on a mesh, the reference's ``NamedSharding``: which
    block of a leaf this rank holds, and whether it holds the first copy
    of it. A plain class, so a tree walk takes it as a leaf."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: Placement):
        self.mesh, self.spec = mesh, tuple(spec)

    def global_shape(self, local_shape) -> tuple[int, ...]:
        """The whole leaf's shape from this rank's block's."""
        shape = list(local_shape)
        for dim, axes in enumerate(self.spec):
            if axes is not None:
                shape[dim] *= self.mesh.size(axes)
        return tuple(shape)

    def region(self, shape) -> list[list[int]]:
        """This rank's block of a leaf of global ``shape``, as
        [[start, stop], ...] per dim (the checkpoint's index form)."""
        region = [[0, int(d)] for d in shape]
        for dim, axes in enumerate(self.spec):
            if axes is None:
                continue
            n = self.mesh.size(axes)
            if shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"divide over {axes} ({n})")
            size = shape[dim] // n
            start = self.mesh.index(axes) * size
            region[dim] = [start, start + size]
        return region

    @property
    def first_replica(self) -> bool:
        """True on the rank at coordinate 0 of every axis that does not
        split the leaf (the reference's ``replica_id == 0``): the one
        that writes this block."""
        split = {a for axes in self.spec if axes is not None
                 for a in _axes(axes)}
        return all(self.mesh.coords[a] == 0 for a in AXES if a not in split)

    def __repr__(self) -> str:
        return f"Sharding({self.mesh.shape}, {self.spec})"


def local_block(mesh: Mesh, tensor, placement: Placement):
    """This rank's block of a whole ``tensor`` under ``placement``, a
    contiguous copy."""
    region = Sharding(mesh, placement).region(tuple(tensor.shape))
    block = tensor[tuple(slice(start, stop) for start, stop in region)]
    return block.contiguous().clone()


def gather_block(mesh: Mesh, block, placement: Placement):
    """The whole tensor from every rank's ``block`` under ``placement``
    (an all-gather along each sharded dim; collective over the world)."""
    from kubeflow_tpu_torch.parallel.collectives import all_gather_dim

    whole = block
    for dim, axes in enumerate(placement):
        if axes is not None:
            whole = all_gather_dim(whole, dim, mesh.group(axes))
    return whole

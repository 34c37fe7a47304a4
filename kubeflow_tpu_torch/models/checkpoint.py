"""Crash-consistent checkpointing for the port's training state.

The counterpart of ``kubeflow_tpu/models/checkpoint.py``, with its
on-disk format: a checkpoint the JAX package writes restores here and
the reverse, and for the same state the two write the same shard bytes
(the same per-shard digests). The commit protocol is the reference's
(one step = one directory):

1. every process writes its shards into ``_tmp.<step>/`` —
   ``shard-<pid>.bin`` (raw C-order payloads) + ``shard-<pid>.json``
   (offsets, indices, per-shard sha256) — each fsynced;
2. all processes reach the commit barrier;
3. process 0 writes ``MANIFEST.json`` (step, topology fingerprint,
   per-file sha256) into the tmp dir, last;
4. process 0 renames ``_tmp.<step>`` → ``<step>`` and fsyncs the
   parent: the rename is the commit point.

``restore_latest_valid`` verifies manifest, file digests, per-shard
content digests and coverage, and falls back to the previous step on
any corruption. Multi-process, process 0 walks and validates and every
rank restores the step it broadcasts.

Where the port differs from the reference, and why:

- Leaves are keyed by the reference's ``keystr`` paths, in its flatten
  order (dict keys sorted). The port's :class:`TrainState` has no
  ``batch_stats`` and holds ``step`` and the optimizer's ``count`` as
  Python ints; they are written as int32 0-d leaves under
  ``['step']`` and ``['opt_state'][0].count``, as optax's state puts
  them, with mu and nu under ``['opt_state'][0].mu[...]``/``.nu[...]``.
- bfloat16 needs no ``ml_dtypes``: its payload is the tensor's raw
  2-byte words, read back as int16 and viewed as ``torch.bfloat16``.
  A restore casts each leaf to the template's dtype in torch (f32 →
  bf16 rounds to nearest, ties to even, as ``ml_dtypes`` does).
- A save's snapshot copies every leaf to host memory before it returns
  (one ``torch.cuda.synchronize`` first): the port's train step updates
  the state's tensors in place, so the writer thread must not read
  them. The payload then streams to its file leaf by leaf, hashed on
  the way, instead of being built in one host buffer.
- The state is replicated on every rank (no sharded tensors yet), so
  process 0 writes every leaf whole; restore assembles whole leaves on
  the template's device. ``placements``/``mesh`` belong to the parallel
  slice (ROADMAP A10) and raise.
- The multi-process transport is ``torch.distributed``'s store when a
  process group is initialised (the reference uses jax.distributed's
  coordination service); injected ``barrier``/``broadcast`` callables
  take its place as in the reference.
- Metrics render through the port's ``obs/exposition.py`` (no
  ``prometheus_client``), under the reference's names.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import mmap
import os
import shutil
import threading
import time
from datetime import timedelta

import numpy as np
import torch

from kubeflow_tpu_torch.models.optim import AdamWState
from kubeflow_tpu_torch.models.train import TrainState
from kubeflow_tpu_torch.obs.exposition import (
    Counter,
    Gauge,
    Histogram,
    Registry,
)
from kubeflow_tpu_torch.obs.metrics import BucketHistogram
from kubeflow_tpu_torch.obs.trace import get_tracer

log = logging.getLogger(__name__)

MANIFEST_NAME = "MANIFEST.json"
TMP_PREFIX = "_tmp."
MANIFEST_FORMAT = 1

# Env the webhook's PodDefault injects into every pod and the train loop
# reads back (run_with_checkpointing callers).
ENV_CHECKPOINT_DIR = "KFT_CHECKPOINT_DIR"
ENV_CHECKPOINT_EVERY_STEPS = "KFT_CHECKPOINT_EVERY_STEPS"
ENV_CHECKPOINT_EVERY_S = "KFT_CHECKPOINT_EVERY_S"
ENV_CHECKPOINT_KEEP = "KFT_CHECKPOINT_KEEP"


class CheckpointCorrupt(Exception):
    """A step directory failed validation (torn write, digest mismatch,
    missing shard). ``restore_latest_valid`` treats it as "skip this
    step and fall back"; direct ``restore`` surfaces it."""


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

# prometheus_client's default histogram buckets, which the reference's
# save-duration histogram takes.
_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75,
                    1.0, 2.5, 5.0, 7.5, 10.0)


class CheckpointMetrics:
    """Plain in-process values (what the tests and the train loop read)
    mirrored into a :class:`Registry` under the reference's names:

    - ``checkpoint_save_duration_seconds`` (histogram)
    - ``checkpoint_last_committed_step`` (gauge)
    - ``checkpoint_restore_total{outcome}`` (counter; ``resumed``,
      ``resumed_cross_topology``, ``skipped_corrupt``, ``none``)
    """

    def __init__(self, registry: Registry | None = None):
        self.save_duration = BucketHistogram(exemplars=True)
        self.last_committed_step: int | None = None
        self.restore_total: dict[str, int] = {}
        self._lock = threading.Lock()
        self.registry = registry or Registry()
        self._duration = Histogram(
            "checkpoint_save_duration_seconds",
            "Wall time of one checkpoint save (snapshot + durable "
            "write + commit)", registry=self.registry,
            buckets=_DEFAULT_BUCKETS)
        Gauge("checkpoint_last_committed_step",
              "Step number of the most recently committed checkpoint",
              registry=self.registry).set_function(
                  lambda: self.last_committed_step or 0)
        self._restore = Counter("checkpoint_restore_total",
                                "Checkpoint restore attempts by outcome",
                                ["outcome"], registry=self.registry)

    def observe_save(self, seconds: float, step: int) -> None:
        with self._lock:
            self.save_duration.observe(seconds)
            self.last_committed_step = step
        self._duration.observe(seconds)

    def observe_restore(self, outcome: str) -> None:
        with self._lock:
            self.restore_total[outcome] = (
                self.restore_total.get(outcome, 0) + 1)
        self._restore.labels(outcome).inc()


# ---------------------------------------------------------------------------
# durable-write helpers
# ---------------------------------------------------------------------------


def _write_bytes(path: str, data, fsync: bool = True) -> None:
    """tmp-file + os.replace + fsync: the file either has all of
    ``data`` (bytes, or an iterable of buffers written in order) or does
    not exist under its final name."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = (data,)
    tmp = path + ".part"
    with open(tmp, "wb") as fh:
        for chunk in data:
            fh.write(chunk)
        fh.flush()
        if fsync:
            os.fsync(fh.fileno())
    os.replace(tmp, path)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without dir-fd fsync: degrade silently
    try:
        os.fsync(fd)
    except OSError:
        pass  # analysis: allow[py-broad-except]
    finally:
        os.close(fd)


def _sha256(data) -> str:
    return hashlib.sha256(data).hexdigest()


class _StoreClient:
    """The coordination-client calls the manager makes, over
    ``torch.distributed``'s key-value store."""

    def __init__(self, store, world: int):
        self._store = store
        self._world = world

    def wait_at_barrier(self, name: str, timeout_in_ms: int) -> None:
        if self._store.add(f"{name}/arrived", 1) == self._world:
            self._store.set(f"{name}/open", b"1")
        self._store.wait([f"{name}/open"],
                         timedelta(milliseconds=timeout_in_ms))

    def key_value_set(self, key: str, value: str) -> None:
        self._store.set(key, value)

    def blocking_key_value_get(self, key: str, timeout_in_ms: int) -> str:
        self._store.wait([key], timedelta(milliseconds=timeout_in_ms))
        return self._store.get(key).decode()

    def key_value_delete(self, key: str) -> None:
        self._store.delete_key(key)


def _coordination_client():
    """The initialised process group's store as a coordination client,
    or None when no multi-process world is up."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed import distributed_c10d

    return _StoreClient(distributed_c10d._get_default_store(),
                        dist.get_world_size())


# Every this-many agreements, rendezvous the world and GC consumed kv
# keys: a run whose consult is armed but that never saves must not grow
# the store with one write-once key per step.
_BCAST_GC_EVERY = 256

# Module-level so that managers created per call continue their
# predecessor's numbering: kv keys and barrier ids are write-once, and
# an instance restarting at 1 would collide with an earlier one's keys.
# Keyed by (directory, process_id[, step]) so tests simulating several
# ranks in one OS process keep them distinct.
_AGREE_SEQS: dict[tuple, int] = {}
_SAVE_ATTEMPTS: dict[tuple, int] = {}
_SHARED_LOCK = threading.Lock()

ENV_COORD_TIMEOUT_MS = "KFT_COORD_TIMEOUT_MS"


def _coord_timeout_ms() -> int:
    """Barrier / kv-agreement timeout; generous by default (cross-host
    skew of minutes is normal while ranks warm up)."""
    try:
        return int(os.environ[ENV_COORD_TIMEOUT_MS])
    except (KeyError, ValueError):
        return 600_000


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    """Streaming digest: a multi-GB payload is never held whole."""
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                return digest.hexdigest()
            digest.update(block)


def _resolve_dtype(name: str) -> tuple[np.dtype, torch.dtype | None]:
    """(numpy storage dtype, torch dtype) of a leaf's dtype name.
    bfloat16 is stored as its raw 2-byte words (int16 here); a dtype
    torch lacks has no torch side (None)."""
    if name == "bfloat16":
        return np.dtype(np.int16), torch.bfloat16
    storage = np.dtype(name)
    try:
        return storage, torch.from_numpy(np.empty(0, storage)).dtype
    except TypeError:
        return storage, None


def _normalize_index(index, shape) -> list[list[int]]:
    """Shard index (tuple of slices) → [[start, stop], ...] with Nones
    resolved against the global shape."""
    out = []
    for slc, dim in zip(index, shape):
        start = 0 if slc.start is None else int(slc.start)
        stop = dim if slc.stop is None else int(slc.stop)
        out.append([start, stop])
    return out


# ---------------------------------------------------------------------------
# host-side snapshot
# ---------------------------------------------------------------------------


def _arrays_only(state):
    """TrainState -> the reference's array fields, keyed as its
    TrainState flattens: ``step`` and the AdamW ``count`` as int32 0-d,
    an empty ``batch_stats``, the AdamW state as the first entry of the
    optimizer chain. Static fields (tx, apply_fn) restore from the
    template. Any other tree is returned as it is."""
    if not isinstance(state, TrainState):
        return state
    opt = state.opt_state
    if isinstance(opt, AdamWState):
        opt = (dataclasses.replace(opt, count=np.int32(int(opt.count))),)
    return {"step": np.int32(int(state.step)), "params": state.params,
            "batch_stats": {}, "opt_state": opt}


def _merge_static(like, restored):
    if not isinstance(like, TrainState):
        return restored
    opt = restored["opt_state"]
    if isinstance(like.opt_state, AdamWState):
        opt = dataclasses.replace(opt[0], count=int(opt[0].count))
    return dataclasses.replace(like, step=int(restored["step"]),
                               params=restored["params"], opt_state=opt)


def _is_node(tree) -> bool:
    return (isinstance(tree, (dict, list, tuple))
            or (dataclasses.is_dataclass(tree) and not isinstance(tree, type)))


def _children(tree) -> list[tuple[str, object]]:
    """(key suffix, child) pairs in the reference's flatten order: dict
    keys sorted, sequences by index, dataclass fields (optax's
    NamedTuple states) in declaration order."""
    if isinstance(tree, dict):
        return [(f"[{key!r}]", tree[key]) for key in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", child) for i, child in enumerate(tree)]
    return [(f".{f.name}", getattr(tree, f.name))
            for f in dataclasses.fields(tree)]


def _flatten_keys(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(keystr path, leaf) pairs, as ``jax.tree_util.keystr`` names
    them; None is an empty subtree."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for suffix, child in _children(tree):
        out.extend(_flatten_keys(child, prefix + suffix))
    return out


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in flatten order,
    from the iterator ``leaves``."""
    if tree is None:
        return None
    if not _is_node(tree):
        return next(leaves)
    if isinstance(tree, dict):
        rebuilt = {key: _unflatten(tree[key], leaves) for key in sorted(tree)}
        return {key: rebuilt[key] for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(child, leaves) for child in tree)
    return dataclasses.replace(tree, **{
        f.name: _unflatten(getattr(tree, f.name), leaves)
        for f in dataclasses.fields(tree)})


@dataclasses.dataclass
class _HostLeaf:
    key: str
    shape: tuple
    dtype: str
    # [(normalized index, contiguous np array)]; only process 0 writes
    # (the state is replicated on every rank).
    shards: list


def _host_copy(leaf) -> tuple[np.ndarray, str]:
    """A private C-order host copy of one leaf and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True,
                             memory_format=torch.contiguous_format)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf, copy=True, order="C")
    return arr, str(arr.dtype)


def _leaf_meta(leaf) -> tuple[tuple, str]:
    """A leaf's shape and dtype name as :func:`_host_copy` gives them,
    without copying it."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return tuple(leaf.shape), "bfloat16"
        return tuple(leaf.shape), str(
            torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    arr = np.asarray(leaf)
    return tuple(arr.shape), str(arr.dtype)


def _snapshot(state, process_id: int) -> list[_HostLeaf]:
    """Device → host copy of every leaf: the only part of a save that
    runs synchronously with the train loop. The copies are real (the
    next in-place step must not reach the writer thread's bytes). Only
    process 0 writes, so the other ranks take each leaf's shape and
    dtype and copy nothing."""
    leaves = _flatten_keys(_arrays_only(state))
    if process_id != 0:
        return [_HostLeaf(key, *_leaf_meta(leaf), []) for key, leaf in leaves]
    if any(isinstance(leaf, torch.Tensor) and leaf.is_cuda
           for _, leaf in leaves):
        torch.cuda.synchronize()
    out = []
    for key, leaf in leaves:
        arr, dtype = _host_copy(leaf)
        shape = tuple(arr.shape)
        whole = _normalize_index(tuple(slice(0, d) for d in shape), shape)
        out.append(_HostLeaf(key, shape, dtype, [(whole, arr)]))
    return out


def _raw(arr: np.ndarray) -> memoryview:
    """The C-order bytes of ``arr`` without a copy."""
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Atomic, digest-verified, multi-process-aware checkpoint store.

    Parameters (the reference's):

    - ``directory``: checkpoint root; committed steps are numbered
      subdirectories.
    - ``keep``: committed steps retained by GC (process 0, post-commit).
    - ``process_id`` / ``process_count``: multi-process identity;
      process 0 is the manifest writer / committer.
    - ``barrier``: callable run before the manifest write and after the
      commit; defaults to the process group's store and a no-op for a
      single process.
    - ``broadcast``: ``fn(key, value) -> value`` overriding the
      transport of :meth:`broadcast_from_zero`.
    - ``fingerprint``: extra dict merged into the manifest's topology
      fingerprint.
    - ``hook``: ``fn(point: str, info: dict)`` called at named save
      points (``shard_written``, ``pre_manifest``, ``manifest_written``,
      ``committed``): the chaos tier's kill-injection surface.
    """

    def __init__(self, directory, *, keep: int = 3, process_id: int = 0,
                 process_count: int = 1, barrier=None, broadcast=None,
                 fingerprint: dict | None = None,
                 metrics: CheckpointMetrics | None = None, hook=None,
                 fsync: bool = True):
        self.directory = os.path.abspath(os.fspath(directory))
        self.keep = int(keep)
        self.process_id = int(process_id)
        self.process_count = int(process_count)
        self._barrier = barrier
        self.fingerprint = dict(fingerprint or {})
        self.metrics = metrics or CheckpointMetrics()
        self._hook = hook
        self._fsync = fsync
        self._broadcast = broadcast
        self._inflight: threading.Thread | None = None
        self._inflight_error: BaseException | None = None
        self._bcast_keys: list[str] = []
        self._bcast_lock = threading.Lock()
        # Two managers over different dirs in one world must not share
        # barrier/kv identities (write-once store).
        self._ns = hashlib.sha256(self.directory.encode()).hexdigest()[:8]
        self.last_error: BaseException | None = None
        # Set by restore_latest_valid: {"step", "cross_topology",
        # "mismatch"} of the restore that fed this run.
        self.last_restore: dict | None = None

    # ---- small internals -------------------------------------------------
    def _emit(self, point: str, **info) -> None:
        if self._hook is not None:
            self._hook(point, info)

    def _sync(self, name: str) -> None:
        """Rendezvous every process at a named point. ``name`` derives
        from shared state (step + per-step attempt), never a local
        counter, so an aborted save cannot shift later barriers."""
        if self._barrier is not None:
            self._barrier()  # injected transports own their naming
            return
        if self.process_count <= 1:
            return
        client = _coordination_client()
        if client is None:
            raise RuntimeError(
                "a multi-process checkpoint needs a transport: initialise "
                "torch.distributed or pass barrier=/broadcast=")
        client.wait_at_barrier(f"kft-ckpt-{self._ns}-{name}",
                               timeout_in_ms=_coord_timeout_ms())

    def broadcast_from_zero(self, tag: str, value: str) -> str:
        """Agree on a small string across the world: process 0's
        ``value`` is published through the store (or the injected
        ``broadcast`` transport) and everyone returns it. Any decision
        that steers collective checkpoint behaviour (the wall-clock
        cadence, the SIGTERM stop, the restore step) routes through
        here. Calls must be collective; a single process returns
        ``value`` unchanged."""
        if self.process_count <= 1:
            return value
        with _SHARED_LOCK:
            skey = (self.directory, self.process_id)
            seq = _AGREE_SEQS.get(skey, 0) + 1
            _AGREE_SEQS[skey] = seq
        key = f"{tag}.{seq}"
        if self._broadcast is not None:
            return str(self._broadcast(key, value))
        client = _coordination_client()
        if client is None:
            raise RuntimeError(
                "a multi-process agreement needs a transport: initialise "
                "torch.distributed or pass broadcast=")
        full = f"kft-bcast-{self._ns}-{key}"
        if self.process_id == 0:
            client.key_value_set(full, value)
            with self._bcast_lock:
                self._bcast_keys.append(full)
            agreed = value
        else:
            agreed = client.blocking_key_value_get(full,
                                                   _coord_timeout_ms())
        if seq % _BCAST_GC_EVERY == 0:
            # Past this barrier every rank has read every key so far.
            self._sync(f"bcast-gc-{seq}")
            self._gc_broadcast_keys(self._take_bcast_keys())
        return agreed

    def _gc_broadcast_keys(self, keys) -> None:
        """Delete agreement keys every rank has provably consumed (the
        commit barrier just rendezvoused the world)."""
        if not keys:
            return
        client = _coordination_client()
        if client is None or not hasattr(client, "key_value_delete"):
            return
        for key in keys:
            try:
                client.key_value_delete(key)
            except Exception as exc:
                log.debug("kv gc of %s failed: %s", key, exc)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _tmp_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{TMP_PREFIX}{int(step)}")

    # ---- save ------------------------------------------------------------
    def save(self, step: int, state) -> str:
        """Synchronous save: blocks until the step is committed durable
        (or raises). Returns the committed step directory."""
        self.wait()
        host = _snapshot(state, self.process_id)
        return self._write(int(step), host, self._take_bcast_keys())

    def save_async(self, step: int, state) -> None:
        """Background save: the host snapshot is taken before this
        returns (the caller may step the state in place right after);
        the durable write runs on a worker thread. At most one save is
        in flight: a second call first waits out the previous one (and
        surfaces its error)."""
        self.wait()
        host = _snapshot(state, self.process_id)
        # Taken on the caller thread: exactly the keys published before
        # this save, which every rank consumed before its own save.
        consumed = self._take_bcast_keys()

        def _run():
            try:
                self._write(int(step), host, consumed)
            except BaseException as exc:
                log.warning("background checkpoint save of step %d "
                            "failed: %s", step, exc)
                self._inflight_error = exc

        self._inflight_error = None
        self._inflight = threading.Thread(target=_run,
                                          name=f"ckpt-save-{step}",
                                          daemon=True)
        self._inflight.start()

    def wait(self) -> None:
        """Join any in-flight background save; re-raise its failure."""
        thread, self._inflight = self._inflight, None
        if thread is not None:
            thread.join()
        error, self._inflight_error = self._inflight_error, None
        if error is not None:
            self.last_error = error
            raise error

    def _take_bcast_keys(self) -> list[str]:
        with self._bcast_lock:
            keys = self._bcast_keys[:]
            self._bcast_keys.clear()
        return keys

    def _write(self, step: int, host: list[_HostLeaf],
               consumed_keys=()) -> str:
        t0 = time.perf_counter()
        with get_tracer().span("checkpoint save"):
            # Saves are collectively agreed, so the per-rank attempt
            # counts advance in lockstep and name the barriers.
            with _SHARED_LOCK:
                akey = (self.directory, self.process_id, step)
                attempt = _SAVE_ATTEMPTS.get(akey, 0)
                _SAVE_ATTEMPTS[akey] = attempt + 1
            tmp = self._tmp_dir(step)
            os.makedirs(tmp, exist_ok=True)

            # The payload streams leaf by leaf, each shard hashed as it
            # goes; the meta is complete once the file is.
            leaves_meta = {}

            def payload():
                offset = 0
                for leaf in host:
                    entries = []
                    for index, data in leaf.shards:
                        raw = _raw(data)
                        entries.append({"index": index, "offset": offset,
                                        "size": raw.nbytes,
                                        "digest": _sha256(raw)})
                        offset += raw.nbytes
                        yield raw
                    leaves_meta[leaf.key] = {"shape": list(leaf.shape),
                                             "dtype": leaf.dtype,
                                             "shards": entries}

            bin_name = f"shard-{self.process_id:05d}.bin"
            meta_name = f"shard-{self.process_id:05d}.json"
            _write_bytes(os.path.join(tmp, bin_name), payload(),
                         self._fsync)
            self._emit("shard_written", step=step, file=bin_name)
            meta = {"process": self.process_id,
                    "process_count": self.process_count,
                    "leaves": leaves_meta}
            _write_bytes(os.path.join(tmp, meta_name),
                         json.dumps(meta, sort_keys=True).encode(),
                         self._fsync)
            if self._fsync:
                _fsync_dir(tmp)

            # Every process's shards are durable past this barrier.
            self._sync(f"{step}.{attempt}-shards")
            self._emit("pre_manifest", step=step)
            if self.process_id == 0:
                self._commit(step, tmp)
            # Nobody returns before the commit landed.
            self._sync(f"{step}.{attempt}-commit")
            self._gc_broadcast_keys(consumed_keys)
        self.metrics.observe_save(time.perf_counter() - t0, step)
        return self._step_dir(step)

    def _commit(self, step: int, tmp: str) -> None:
        expected = sorted(f"shard-{pid:05d}.{ext}"
                          for pid in range(self.process_count)
                          for ext in ("bin", "json"))
        present = sorted(n for n in os.listdir(tmp)
                         if n.startswith("shard-"))
        missing = set(expected) - set(present)
        if missing:
            raise CheckpointCorrupt(
                f"step {step}: shard files missing at the commit barrier: "
                f"{sorted(missing)}")
        # Leftovers of a crashed save from a bigger world are dropped,
        # not manifested.
        for name in set(present) - set(expected):
            os.unlink(os.path.join(tmp, name))
        files = {name: _sha256_file(os.path.join(tmp, name))
                 for name in expected}
        manifest = {"format": MANIFEST_FORMAT, "step": int(step),
                    "created_at": time.time(),
                    "fingerprint": self._fingerprint(), "files": files}
        _write_bytes(os.path.join(tmp, MANIFEST_NAME),
                     json.dumps(manifest, sort_keys=True, indent=1).encode(),
                     self._fsync)
        if self._fsync:
            _fsync_dir(tmp)
        self._emit("manifest_written", step=step)
        final = self._step_dir(step)
        if os.path.isdir(final):  # re-save of the same step: replace
            shutil.rmtree(final)
        os.rename(tmp, final)  # THE commit point
        if self._fsync:
            _fsync_dir(self.directory)
        self._emit("committed", step=step)
        self._gc()

    def _fingerprint(self) -> dict:
        cuda = torch.cuda.is_available()
        fp = {"process_count": self.process_count,
              "backend": "gpu" if cuda else "cpu",
              "device_count": torch.cuda.device_count() if cuda else 1}
        fp.update(self.fingerprint)
        return fp

    def _gc(self) -> None:
        """Keep the newest ``keep`` committed steps; drop older ones and
        every dangling ``_tmp.*``. Process 0 only, after a successful
        commit: a failed save never GCs the steps it would fall back
        to."""
        committed = sorted(self.steps(), reverse=True)
        for step in committed[self.keep:]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
        for name in os.listdir(self.directory):
            if name.startswith(TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # ---- enumeration / validation ---------------------------------------
    def steps(self) -> list[int]:
        """Committed steps (numeric directory + manifest), ascending."""
        try:
            names = os.listdir(self.directory)
        except (FileNotFoundError, NotADirectoryError):
            return []
        out = []
        for name in names:
            if not name.isdigit():
                continue
            full = os.path.join(self.directory, name)
            if os.path.isdir(full) and os.path.isfile(
                    os.path.join(full, MANIFEST_NAME)):
                out.append(int(name))
        return sorted(out)

    def latest_committed_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def validate(self, step: int) -> list[str]:
        """Problems with a committed step ([] = valid)."""
        return _validate_step_dir(self._step_dir(step))

    def step_fingerprint(self, step: int) -> dict:
        manifest = _read_manifest(self._step_dir(step))
        fp = manifest.get("fingerprint")
        return dict(fp) if isinstance(fp, dict) else {}

    def _note_restored(self, step: int) -> None:
        """Classify a successful restore: ``resumed``, or
        ``resumed_cross_topology`` when the step's saved fingerprint
        disagrees with the live world on a shared key."""
        try:
            saved = self.step_fingerprint(step)
        except CheckpointCorrupt:
            saved = {}
        current = json.loads(json.dumps(self._fingerprint(), sort_keys=True,
                                        default=str))
        mismatch = {key: {"saved": saved[key], "current": current[key]}
                    for key in sorted(set(saved) & set(current))
                    if saved[key] != current[key]}
        self.last_restore = {"step": int(step),
                             "cross_topology": bool(mismatch),
                             "mismatch": mismatch}
        if mismatch:
            self.metrics.observe_restore("resumed_cross_topology")
            log.info("cross-topology restore of step %d: checkpoint was "
                     "saved under a different world (%s)", step, mismatch)
        else:
            self.metrics.observe_restore("resumed")

    # ---- restore ---------------------------------------------------------
    def restore(self, step: int, like, placements=None):
        """Restore one committed step into the shape of ``like``.
        Raises :class:`CheckpointCorrupt` on any validation failure."""
        with get_tracer().span("checkpoint restore"):
            return _load_step_dir(self._step_dir(step), like, placements)

    def restore_latest_valid(self, like, placements=None):
        """(state, step) from the newest step that passes validation,
        skipping torn/corrupt ones; None when none exists. Multi-process,
        process 0 picks the step and every rank restores that one (and
        fails loudly if it cannot, instead of falling back alone)."""
        if self.process_count > 1:
            step = self._agree_restore_step()
            if step is None:
                self.metrics.observe_restore("none")
                return None
            state = self.restore(step, like, placements)  # loud on fail
            self._note_restored(step)
            return state, step
        for step in sorted(self.steps(), reverse=True):
            # The load verifies manifest, presence, per-shard digests and
            # coverage in one pass.
            try:
                state = self.restore(step, like, placements)
                self._note_restored(step)
                return state, step
            except CheckpointCorrupt as exc:
                self.metrics.observe_restore("skipped_corrupt")
                log.warning("checkpoint step %d is torn/corrupt, falling "
                            "back (%s)", step, exc)
        self.metrics.observe_restore("none")
        return None

    def _agree_restore_step(self) -> int | None:
        """Process 0 walks committed steps newest-first, fully validates
        each, and broadcasts its pick ("" = nothing valid)."""
        chosen = ""
        if self.process_id == 0:
            for step in sorted(self.steps(), reverse=True):
                problems = self.validate(step)
                if not problems:
                    chosen = str(step)
                    break
                self.metrics.observe_restore("skipped_corrupt")
                log.warning("checkpoint step %d is torn/corrupt, skipping "
                            "(%s)", step, "; ".join(problems))
        agreed = self.broadcast_from_zero("restore", chosen)
        return int(agreed) if agreed else None


# ---------------------------------------------------------------------------
# step-directory readers
# ---------------------------------------------------------------------------


def _validate_step_dir(step_dir: str) -> list[str]:
    manifest_path = os.path.join(step_dir, MANIFEST_NAME)
    try:
        with open(manifest_path, "rb") as fh:
            manifest = json.loads(fh.read())
    except (OSError, ValueError) as exc:
        return [f"manifest unreadable: {exc}"]
    files = manifest.get("files")
    if not isinstance(files, dict) or not files:
        return ["manifest lists no shard files"]
    problems = []
    for name, digest in sorted(files.items()):
        try:
            actual = _sha256_file(os.path.join(step_dir, name))
        except OSError as exc:
            problems.append(f"shard file {name} missing: {exc}")
            continue
        if actual != digest:
            problems.append(f"shard file {name} digest mismatch")
    return problems


def _read_manifest(step_dir: str) -> dict:
    try:
        with open(os.path.join(step_dir, MANIFEST_NAME), "rb") as fh:
            return json.loads(fh.read())
    except (OSError, ValueError) as exc:
        raise CheckpointCorrupt(
            f"{step_dir}: manifest unreadable: {exc}") from exc


class _ShardPayloads:
    """mmap-backed access to a step's shard payloads with lazy, memoized
    per-shard digest verification: only the byte ranges a restore
    touches are read and hashed."""

    def __init__(self, step_dir: str, names):
        self._step_dir = step_dir
        self._maps: dict[str, object] = {}
        self._verified: set[tuple] = set()
        for name in names:
            full = os.path.join(step_dir, name)
            try:
                with open(full, "rb") as fh:
                    size = os.fstat(fh.fileno()).st_size
                    self._maps[name] = (
                        mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
                        if size else b"")
            except OSError as exc:
                raise CheckpointCorrupt(
                    f"{step_dir}: shard file {name} missing: {exc}") from exc

    def view(self, name: str, entry: dict, key: str) -> memoryview:
        mm = self._maps.get(name)
        if mm is None:
            raise CheckpointCorrupt(
                f"{self._step_dir}: payload {name} for leaf {key} missing")
        off, size = int(entry["offset"]), int(entry["size"])
        if off + size > len(mm):
            raise CheckpointCorrupt(
                f"{self._step_dir}: payload {name} truncated (leaf {key})")
        view = memoryview(mm)[off:off + size]
        token = (name, off, size)
        if token not in self._verified:
            if _sha256(view) != entry["digest"]:
                raise CheckpointCorrupt(
                    f"{self._step_dir}: content digest mismatch on leaf "
                    f"{key}")
            self._verified.add(token)
        return view

    def close(self) -> None:
        for mm in self._maps.values():
            if isinstance(mm, mmap.mmap):
                try:
                    mm.close()
                except BufferError:
                    pass  # a live view holds the buffer; GC closes it
        self._maps.clear()


def _read_region(region, dtype, shards, payloads, key):
    """Assemble one region ([[start, stop], ...] in global coordinates)
    of a leaf, in its storage dtype, from the shard entries overlapping
    it. Non-overlapping shards are neither read nor hashed."""
    out = np.empty(tuple(b - a for a, b in region), dtype)
    for bin_name, entry in shards:
        src = [[int(a), int(b)] for a, b in entry["index"]]
        rel_dst, rel_src = [], []
        for (da, db), (sa, sb) in zip(region, src):
            lo, hi = max(da, sa), min(db, sb)
            if lo >= hi:
                break
            rel_dst.append(slice(lo - da, hi - da))
            rel_src.append(slice(lo - sa, hi - sa))
        else:
            view = payloads.view(bin_name, entry, key)
            sub_shape = tuple(b - a for a, b in src)
            try:
                data = np.frombuffer(view, dtype).reshape(sub_shape)
            except ValueError as exc:
                raise CheckpointCorrupt(
                    f"payload {bin_name} size disagrees with its index "
                    f"(leaf {key}): {exc}") from exc
            out[tuple(rel_dst)] = data[tuple(rel_src)]
            del data
            view.release()
    return out


def _to_template(data: np.ndarray, stored: str, tmpl):
    """One assembled leaf (storage dtype) in the template's form: a
    tensor on the template's device in its dtype (requiring grad where
    the template does), or a numpy array in the template's dtype (the
    reference's host restore). Casts involving bfloat16 run in torch."""
    if isinstance(tmpl, torch.Tensor):
        t = torch.from_numpy(data)
        if stored == "bfloat16":
            t = t.view(torch.bfloat16)
        t = t.to(device=tmpl.device, dtype=tmpl.dtype)
        return t.requires_grad_(True) if tmpl.requires_grad else t
    target = getattr(tmpl, "dtype", None)
    if target is None:
        target = np.dtype(stored) if stored != "bfloat16" else None
    else:
        target = np.dtype(target)
    if stored != "bfloat16" and (target is None or target.name != "bfloat16"):
        return data.astype(target) if target != data.dtype else data
    # bfloat16 on either side: cast in torch, hand back raw words viewed
    # as the template's own (ml_dtypes) dtype where it is bfloat16.
    t = torch.from_numpy(data)
    if stored == "bfloat16":
        t = t.view(torch.bfloat16)
    if target is None:
        return t
    if target.name == "bfloat16":
        return t.to(torch.bfloat16).view(torch.int16).numpy().view(target)
    return t.to(_resolve_dtype(target.name)[1]).numpy()


def _load_step_dir(step_dir: str, like, placements=None):
    """Assemble every leaf of ``like`` from the step's shard files, whole,
    in the template's form (see :func:`_to_template`). Payloads are
    mmapped and digest-verified shard by shard on first touch."""
    if placements is not None:
        raise NotImplementedError(
            "sharded placements belong to the parallel/ slice of the port "
            "(ROADMAP A10)")
    manifest = _read_manifest(step_dir)
    metas: list[dict] = []
    bin_names: list[str] = []
    for name in sorted(manifest.get("files") or {}):
        if not name.endswith(".json"):
            bin_names.append(name)
            continue
        try:
            with open(os.path.join(step_dir, name), "rb") as fh:
                metas.append(json.loads(fh.read()))
        except (OSError, ValueError) as exc:
            raise CheckpointCorrupt(
                f"{step_dir}: shard meta {name} unreadable: {exc}") from exc

    # leaf key -> merged view across every process's meta.
    leaves: dict[str, dict] = {}
    for meta in metas:
        bin_name = f"shard-{int(meta.get('process', 0)):05d}.bin"
        for key, info in (meta.get("leaves") or {}).items():
            slot = leaves.setdefault(key, {"shape": tuple(info["shape"]),
                                           "dtype": info["dtype"],
                                           "shards": []})
            if slot["shape"] != tuple(info["shape"]):
                raise CheckpointCorrupt(
                    f"{step_dir}: leaf {key} shape disagrees across "
                    "process metas")
            for entry in info["shards"]:
                slot["shards"].append((bin_name, entry))

    arrays = _arrays_only(like)
    payloads = _ShardPayloads(step_dir, bin_names)
    try:
        restored_leaves = []
        for key, tmpl_leaf in _flatten_keys(arrays):
            info = leaves.get(key)
            if info is None:
                raise CheckpointCorrupt(
                    f"{step_dir}: leaf {key} absent from every shard meta")
            shape = info["shape"]
            tmpl_shape = tuple(getattr(tmpl_leaf, "shape",
                                       np.shape(tmpl_leaf)))
            if shape != tmpl_shape:
                raise ValueError(
                    f"checkpoint leaf {key} has shape {shape}, template "
                    f"expects {tmpl_shape}")
            storage, _ = _resolve_dtype(info["dtype"])
            # Dedupe by global index: a leaf written once per process
            # with the same covering index is counted once.
            unique = {tuple(tuple(int(x) for x in pair)
                            for pair in entry["index"]): (bin_name, entry)
                      for bin_name, entry in info["shards"]}
            shards = list(unique.values())
            covered = sum(
                int(np.prod([b - a for a, b in entry["index"]],
                            dtype=np.int64)) if entry["index"] else 1
                for _name, entry in shards)
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if covered != size:
                raise CheckpointCorrupt(
                    f"{step_dir}: leaf {key} coverage {covered}/{size} "
                    "elements (missing shards)")
            data = _read_region([[0, d] for d in shape], storage, shards,
                                payloads, key)
            restored_leaves.append(_to_template(data, info["dtype"],
                                                tmpl_leaf))
    finally:
        payloads.close()
    restored = _unflatten(arrays, iter(restored_leaves))
    return _merge_static(like, restored)


# ---------------------------------------------------------------------------
# thin wrappers
# ---------------------------------------------------------------------------


def _world_identity() -> dict:
    """process_id/process_count from the live torch.distributed world
    ({} without one), so the wrappers keep the manager's multi-process
    discipline."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return {}
    return {"process_id": dist.get_rank(),
            "process_count": dist.get_world_size()}


def save_checkpoint(path, state, step: int | None = None):
    """Write ``state`` (TrainState or any tree of tensors and arrays)
    under ``path``; blocks until durable and committed. With ``step``,
    ``path`` is a checkpoint root and the step directory is returned;
    without, ``path`` itself is the (single) checkpoint."""
    path = os.path.abspath(os.fspath(path))
    manager = CheckpointManager(path, **_world_identity())
    if step is not None:
        return manager.save(step, state)
    manager.save(0, state)
    return path


def restore_checkpoint(path, like, mesh=None, tp_rules: dict | None = None):
    """Restore into the shape of ``like`` (a TrainState template from
    ``create_lm_state`` or any tree). ``path`` may be a checkpoint root
    (the newest valid step), a step directory, or a stepless
    ``save_checkpoint`` target. ``mesh``/``tp_rules`` belong to the
    parallel slice (ROADMAP A10)."""
    if mesh is not None or tp_rules is not None:
        raise NotImplementedError(
            "restoring onto a mesh belongs to the parallel/ slice of the "
            "port (ROADMAP A10)")
    path = os.path.abspath(os.fspath(path))
    if os.path.isfile(os.path.join(path, MANIFEST_NAME)):
        problems = _validate_step_dir(path)
        if problems:
            raise CheckpointCorrupt(f"{path}: " + "; ".join(problems))
        return _load_step_dir(path, like)
    manager = CheckpointManager(path, **_world_identity())
    if (os.path.isfile(os.path.join(path, "0", MANIFEST_NAME))
            and manager.steps() == [0]):
        return manager.restore(0, like)
    result = manager.restore_latest_valid(like)
    if result is None:
        raise FileNotFoundError(
            f"no valid checkpoint under {path} (torn/corrupt steps are "
            "skipped; see checkpoint_restore_total)")
    return result[0]


def latest_step(path) -> int | None:
    """Highest numbered step directory under ``path``, or None. Junk
    entries (non-numeric names, files named like steps, ``_tmp.*``) are
    ignored."""
    path = os.path.abspath(os.fspath(path))
    try:
        names = os.listdir(path)
    except (FileNotFoundError, NotADirectoryError):
        return None
    steps = [int(name) for name in names
             if name.isdigit() and os.path.isdir(os.path.join(path, name))]
    return max(steps, default=None)


# ---------------------------------------------------------------------------
# env plumbing (webhook PodDefault -> training loop)
# ---------------------------------------------------------------------------


def cadence_from_env(env=None) -> tuple[int, float]:
    """(save_every_steps, save_every_s) from the platform-injected env;
    0 disables the respective cadence."""
    env = os.environ if env is None else env

    def _num(key, cast, default):
        try:
            return cast(env.get(key, ""))
        except (TypeError, ValueError):
            return default

    return (_num(ENV_CHECKPOINT_EVERY_STEPS, int, 0),
            _num(ENV_CHECKPOINT_EVERY_S, float, 0.0))


def manager_from_env(env=None, **overrides) -> CheckpointManager | None:
    """A manager rooted at ``KFT_CHECKPOINT_DIR`` with the process
    identity torch.distributed established, or None when the platform
    injected no checkpoint dir (checkpointing disabled)."""
    env = os.environ if env is None else env
    directory = env.get(ENV_CHECKPOINT_DIR)
    if not directory:
        return None
    kwargs: dict = dict(_world_identity())
    try:
        kwargs["keep"] = int(env.get(ENV_CHECKPOINT_KEEP, ""))
    except (TypeError, ValueError):
        pass  # analysis: allow[py-broad-except] — unset/garbage: default
    kwargs.update(overrides)
    return CheckpointManager(directory, **kwargs)

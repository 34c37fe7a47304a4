"""A cell on several cards: one process a card, rank 0 the one the run
started.

Rank 0 starts ranks 1.. as the same command with ``BENCHMARK_RANK`` set
(their standard output goes nowhere; their standard error is rank 0's),
and every rank joins one NCCL world on its own card over a TCP store on
127.0.0.1. A gloo group beside it carries the host's decisions (when a
window opens and closes) and the numbers rank 0 reports for all cards,
so no device work of the benchmark's own runs on the cards. A rank
other than 0 dies with its parent.
"""

from __future__ import annotations

import ctypes
import dataclasses
import datetime
import os
import signal
import socket
import subprocess
import sys
from typing import Any

RANK_ENV = "BENCHMARK_RANK"
PORT_ENV = "BENCHMARK_PORT"
# Every rank's collectives give up after this long rather than hang.
TIMEOUT_S = 300


def rank() -> int:
    return int(os.environ.get(RANK_ENV, "0"))


@dataclasses.dataclass
class World:
    """``rank`` of ``size``; ``control``: the gloo group; ``workers``:
    on rank 0, the processes of ranks 1.."""

    rank: int
    size: int
    control: Any
    workers: list

    def agree(self, flags: list[bool]) -> list[bool]:
        """Each flag set on any rank, on every rank (one gloo call)."""
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(f) for f in flags], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return [bool(v) for v in t.tolist()]

    def reduce(self, values: list[float], op: str = "sum") -> list[float]:
        """``values`` summed (or their ``max``) over the ranks."""
        import torch
        import torch.distributed as dist

        t = torch.tensor(values, dtype=torch.float64)
        dist.all_reduce(t, op=(dist.ReduceOp.MAX if op == "max"
                               else dist.ReduceOp.SUM), group=self.control)
        return t.tolist()

    def finish(self, ok: bool = True) -> bool:
        """Leave the world; on rank 0 wait for every worker (killing
        them unless ``ok``). True when every worker exited 0."""
        import torch.distributed as dist

        if ok:
            dist.destroy_process_group()
        codes = []
        for proc in self.workers:
            if not ok:
                proc.kill()
            try:
                codes.append(proc.wait(timeout=TIMEOUT_S))
            except subprocess.TimeoutExpired:
                proc.kill()
                codes.append(proc.wait())
        return ok and not any(codes)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    libc = ctypes.CDLL("libc.so.6", use_errno=True)
    libc.prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    if os.getppid() == 1:
        os._exit(1)


def start(size: int, module: str, argv: list[str], device_type: str = "cuda",
          cwd=None) -> World:
    """Join (rank 0: start, then join) the world of ``size`` ranks that
    run ``python3 -m <module> <argv>``. On ``device_type="cpu"`` the
    world is gloo (the tests); else each rank takes card ``rank``."""
    import torch
    import torch.distributed as dist

    me, workers = rank(), []
    if me == 0:
        port = _free_port()
        env = {**os.environ, PORT_ENV: str(port)}
        workers = [subprocess.Popen(
            [sys.executable, "-m", module, *argv], cwd=cwd,
            env={**env, RANK_ENV: str(r)}, stdout=subprocess.DEVNULL)
            for r in range(1, size)]
    else:
        _die_with_parent()
        port = int(os.environ[PORT_ENV])
    try:
        if device_type == "cuda":
            torch.cuda.set_device(me)
        dist.init_process_group(
            backend="nccl" if device_type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", world_size=size,
            rank=me, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        control = (dist.new_group(backend="gloo")
                   if device_type == "cuda" else dist.group.WORLD)
    except BaseException:
        for proc in workers:
            proc.kill()
            proc.wait()
        raise
    return World(rank=me, size=size, control=control, workers=workers)

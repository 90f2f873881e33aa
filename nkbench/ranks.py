"""A cell over several ranks: one process a card, as ``torchrun`` starts them.

``python3 nkbench/run.py`` for a cell whose ``chips`` is above 1 is rank 0:
it starts ``chips − 1`` more processes of the same command
(:class:`Launched`) with the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), and every
rank binds ``cuda:<LOCAL_RANK>`` and joins one process group (NCCL; gloo on
the CPU) through the program's ``utils.distributed.initialize``
(:func:`spmd`).  A process started with that environment, by rank 0 or by
``torchrun``, starts no other.  :class:`Group` holds what the harness asks
of the group: a barrier, rank 0's decision, the largest reading, and the
blocks of an answer gathered on rank 0.

Nothing waits without a limit: every collective has the group's timeout
(:data:`TIMEOUT_S`); rank 0 watches the processes it started and, when one
of them fails, ends every one and then itself with a non-zero code; and a
rank whose parent has gone ends itself.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# a collective that waits longer than this ends the run (NCCL's watchdog
# aborts the process); a rank's longest legitimate wait is rank 0 reducing
# the trace and reading the metrics
TIMEOUT_S = 240.0
WAIT_S = 120.0  # rank 0's wait for the others to end after its own run
TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def started() -> bool:
    """Whether this process was started as a rank (the ``torchrun``
    environment is set)."""
    return all(os.environ.get(k) for k in TORCHRUN)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Launched:
    """The ranks 1 … world − 1 that rank 0 started, running ``script`` with
    ``argv``; rank 0's own environment is set to rank 0's.  A watcher ends
    every rank, and this process with code 1, as soon as one of them ends
    with another code than 0."""

    def __init__(self, script: str, argv: Sequence[str], world: int):
        env = dict(os.environ, WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
        os.environ.update(env, RANK="0", LOCAL_RANK="0")
        # the other ranks print nothing on standard output: theirs goes to
        # standard error with their own
        self.procs = [subprocess.Popen(
            [sys.executable, script, *argv], stdin=subprocess.DEVNULL,
            stdout=2, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
            for r in range(1, world)]
        self._done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def _failed(self) -> Optional[Tuple[int, int]]:
        for r, p in enumerate(self.procs, start=1):
            rc = p.poll()
            if rc not in (None, 0):
                return r, rc
        return None

    def _watch(self) -> None:
        while not self._done.wait(0.2):
            bad = self._failed()
            if bad is not None:
                print(f"[nkbench] rank {bad[0]} ended with code {bad[1]}: "
                      f"every rank ends, no result", file=sys.stderr,
                      flush=True)
                self.kill()
                os._exit(1)

    def wait(self, timeout: float = WAIT_S) -> bool:
        """Wait for every rank to end; whether each ended with code 0."""
        deadline = time.monotonic() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            print(f"[nkbench] a rank did not end within {timeout} s of rank "
                  f"0's run: no result", file=sys.stderr, flush=True)
            return False
        finally:
            self._done.set()
        bad = self._failed()
        if bad is not None:
            print(f"[nkbench] rank {bad[0]} ended with code {bad[1]}: no "
                  f"result", file=sys.stderr, flush=True)
        return bad is None

    def kill(self) -> None:
        self._done.set()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


def _end_with_parent() -> None:
    """End this process when the process that started it has gone."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(1.0)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def spmd(script: str, argv: Sequence[str], chips: int,
         device: torch.device, fn: Callable[[], Any]) -> Tuple[Any, bool]:
    """``fn()`` in this process's rank of ``chips`` ranks running ``script``
    with ``argv``: rank 0, unless started as a rank, first starts the
    others.  Every rank joins the process group from the ``torchrun``
    environment (NCCL binding its card ``LOCAL_RANK``, or gloo) before
    ``fn`` and leaves it after.  Returns ``fn``'s result and whether every
    rank this process started ended with code 0; where ``fn`` raises, the
    ranks it started are ended first."""
    from newtonkrylov_tpu_torch.utils import distributed as D

    launched = None if started() else Launched(script, argv, chips)
    try:
        if os.environ.get("RANK") != "0":
            _end_with_parent()
        D.initialize(device=device.type, timeout_s=TIMEOUT_S)
        out = fn()
    except BaseException:
        if launched is not None:
            launched.kill()
        raise
    D.shutdown()
    return out, launched is None or launched.wait()


class Group:
    """This process's rank among a cell's ``chips`` ranks (world 1 for a
    cell on one chip), and the few collectives the harness itself makes,
    each on ``device``."""

    def __init__(self, device: torch.device, chips: int):
        self.world, self.rank, self.device = 1, 0, device
        if chips > 1:
            if dist.is_available() and dist.is_initialized():
                self.world, self.rank = dist.get_world_size(), dist.get_rank()
            if self.world != chips:
                raise RuntimeError(f"the cell runs over {chips} ranks; this "
                                   f"process group has {self.world}")

    @property
    def lead(self) -> bool:
        return self.rank == 0

    def _reduce(self, value: float, op) -> float:
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, op=op)
        return float(t.item())  # the host waits for the device

    def barrier(self) -> None:
        """Return once every rank has reached it (and its card with it)."""
        self._reduce(0.0, dist.ReduceOp.SUM)

    def decide(self, go: bool) -> bool:
        """Rank 0's ``go`` on every rank, once every rank asks."""
        return bool(self._reduce(float(go) if self.lead else 0.0,
                                 dist.ReduceOp.SUM))

    def max(self, value: float) -> float:
        return self._reduce(value, dist.ReduceOp.MAX)

    def gather(self, block: torch.Tensor, origin: Tuple[int, int],
               n: int) -> Optional[torch.Tensor]:
        """On rank 0 the n × n whole, on the host, from every rank's
        ``block`` at ``origin`` (its first row and column); None on the
        others.  Every block has one shape."""
        x = block.to(self.device).contiguous()
        at = torch.tensor(origin, dtype=torch.int64, device=self.device)
        parts: Optional[List[torch.Tensor]] = None
        origins: Optional[List[torch.Tensor]] = None
        if self.lead:
            parts = [torch.empty_like(x) for _ in range(self.world)]
            origins = [torch.empty_like(at) for _ in range(self.world)]
        dist.gather(x, parts, dst=0)
        dist.gather(at, origins, dst=0)
        if not self.lead:
            return None
        whole = torch.empty((n, n), dtype=x.dtype)
        h, w = x.shape
        for part, o in zip(parts, origins):
            r, c = (int(v) for v in o.tolist())
            whole[r:r + h, c:c + w] = part.cpu()
        return whole

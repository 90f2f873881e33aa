"""Tracing and profiling hooks.

Counterpart of ``newtonkrylov_tpu/utils/profiling.py``:

* :func:`time_chain` — iterations/s of a chained step with the dispatch
  overhead cancelled (the JAX package's matvec lanes time with it);
* :class:`PhaseTimer` — named host-side accumulating timers; ``block=``
  synchronizes the devices of the tensors it is given;
* :func:`trace` — a ``torch.profiler`` trace of the block, written into a
  directory as a Chrome/TensorBoard trace file;
* :func:`annotate` — a named range in that trace
  (``torch.profiler.record_function``);
* :func:`solve_report` — a throughput summary of a finished Newton solve.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["PhaseTimer", "trace", "annotate", "solve_report", "time_chain"]


def _synchronize(tree: Any) -> None:
    """Wait for the work queued on the device of every tensor in ``tree``
    (a CPU tensor's work is already done)."""
    devices = {l.device for l in tree_leaves(tree)
               if isinstance(l, torch.Tensor) and l.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def time_chain(fn, a, b, *, chain: int = 200, repeats: int = 3) -> float:
    """Iterations/s of ``x ← fn(x, b)·0.125`` with overhead cancellation.

    The JAX package's protocol: a short chain of ``chain // 10`` steps and a
    long one of ``chain`` steps, each reduced to one scalar and ended with a
    synchronization (where the JAX package reads that scalar with
    ``float()``); the inputs scaled by ``1 + 1e-4·(r+1)`` on repeat r so no
    layer can reuse a result; the best of ``repeats`` of each, and the rate
    from their difference, which cancels the fixed cost of a chain.

    The chain is a Python loop that launches each step's kernels from the
    host, where the JAX package compiles one ``fori_loop``: its rate is set
    by the larger of the device time of a step and the host's dispatch of
    its launches.  Compare the rate with the kernels' device time to see
    which one it is.
    """
    def run(k, x0):
        x = x0
        for _ in range(k):
            x = tree_map(lambda l: l * 0.125, fn(x, b))
        total = torch.stack([l.sum() for l in tree_leaves(x)]).sum()
        _synchronize(total)
        return float(total)

    k_s, k_l = max(1, chain // 10), chain
    run(k_s, a)
    run(k_l, a)

    def best(k):
        ts = []
        for r in range(repeats):
            ar = tree_map(lambda l: l * (1.0 + 1e-4 * (r + 1)), a)
            _synchronize(ar)
            t0 = time.perf_counter()
            run(k, ar)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    dt = best(k_l) - best(k_s)
    return (k_l - k_s) / max(dt, 1e-9)


class PhaseTimer:
    """Accumulating named timers: ``with timer("jvp", block=out): ...``.

    Work on the card is queued, not done, when the host returns: pass the
    tensors the phase produces to ``block=`` (any tree of them) and their
    devices are synchronized before the clock is read."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, block: Any = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block is not None:
                _synchronize(block)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} {t:10.4f}s  x{c:<6d} ({t/max(c,1)*1e3:9.3f} ms/call)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block into ``logdir`` (a
    ``*.pt.trace.json`` file that Chrome's trace viewer, Perfetto and
    TensorBoard read): host events, and the card's kernels when CUDA is
    available.  A profiler that cannot start prints why and the block runs
    untraced, as the JAX package's ``trace`` does."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
        prof.start()
    except Exception as e:  # noqa: BLE001 - a container may refuse CUPTI
        print(f"[profiling] trace unavailable: {e}")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
            except Exception as e:  # noqa: BLE001
                print(f"[profiling] stop_trace failed: {e}")


def annotate(name: str):
    """A named range in a :func:`trace` (a host annotation)."""
    return torch.profiler.record_function(name)


def solve_report(info, n_unknowns: int, wall_s: Optional[float] = None) -> str:
    """Throughput summary for a finished Newton solve."""
    outer = int(info.stats.outer_iterations)
    inner = int(info.stats.inner_iterations)
    t = float(wall_s if wall_s is not None else (info.t or 0.0))
    fl = bool(getattr(info, "floor_limited", False) or False)
    lines = [
        f"solved={bool(info.solved)}  outer={outer}  inner={inner}  "
        f"final |F|={float(info.stats.n_res):.3e}"
        + ("  [floor_limited: tol clamped to the df32 representation floor]"
           if fl else ""),
    ]
    if t > 0:
        lines.append(
            f"wall={t:.3f}s  {inner / t:.1f} matvec/s  "
            f"{n_unknowns * inner / t:.3e} point-updates/s"
        )
    return "\n".join(lines)

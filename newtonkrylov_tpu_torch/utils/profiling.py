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
* :func:`solve_report` — a throughput summary of a finished Newton solve;
* :func:`span` — a named range at one of the program's layer boundaries,
  kept in memory (:func:`spans`) and annotated into a :func:`trace`, while
  spans record (:func:`recording`); :func:`spanned` makes a function's
  calls spans.

**Spans.**  The program opens a span where a layer's work happens:

=====================  ======================================================
``serve``              ``utils.serving.Loaded.call``
``solve``              ``newton_krylov_jit`` / ``newton_krylov``, call to return
``setup``              the initial residual, tolerance and floor estimate
``precond.build``      a preconditioner factory's call (once, or every outer)
``outer``              each Newton (or Ψtc) iteration
``read``               each loop condition read back to the host (``while_loop``)
``linearize``          ``JacobianOperator``'s linearization: the traced J·v
                       graph evaluated at the point, or ``torch.func.linearize``
``linearize.trace``    a trace of the residual's J·v: once a solve in the
                       set-up (``exportable.jvp_graph``), or inside each
                       ``linearize`` that runs ``torch.func.linearize``
``krylov``             the inner solve of an outer
``cg.step``            each CG iteration
``matvec``             each J·v of the inner solve
``precond``            each M⁻¹ (or N⁻¹) apply of the inner solve
``accept``             the outer's acceptance residual and its norm
``gc``                 each collection of Python's garbage collector (in
                       memory only, not in a trace: a collection can run
                       inside a tracer)
=====================  ======================================================

Spans record while a ``torch.profiler`` profile is active on the thread
(so a :func:`trace` shows the program's layers by name) and inside
:func:`recording`; never while ``torch.export`` traces the caller, so an
exported program holds no span.  Otherwise :func:`span` returns one shared
null context.  A record is ``(name, start_ns, end_ns, id, parent,
solve)`` in ``time.time_ns()``, the clock of the profiler's timestamps;
``parent`` is the innermost span open on the thread when it started and
``solve`` the id of the enclosing ``solve`` span (0: none).  The newest
:data:`SPAN_CAPACITY` records are kept; :func:`dropped` counts the rest.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import itertools
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from .. import exportable
from ..tree import tree_leaves, tree_map

__all__ = ["PhaseTimer", "trace", "annotate", "solve_report", "time_chain",
           "span", "spanned", "recording", "is_recording", "spans", "dropped",
           "SpanRecord", "SPAN_CAPACITY"]


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


SPAN_CAPACITY = 1 << 17  # records kept; older ones are dropped and counted


class SpanRecord(NamedTuple):
    """One finished span (see the module)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int  # 0: none open on the thread
    solve: int   # 0: outside any solve


class Dropped(NamedTuple):
    """Records pushed out of the store: how many, and the end of the
    newest of them (a window that ends before it lost nothing)."""

    count: int
    newest_end_ns: int


class _Store:
    """The in-memory spans: the records, the open spans of each thread,
    the count of :func:`recording` blocks open.  No lock: a garbage
    collection can open a ``gc`` span between any two statements here, on
    the same thread, and a deque's append is atomic."""

    def __init__(self):
        self.records = collections.deque(maxlen=SPAN_CAPACITY)
        self.n_dropped = 0
        self.dropped_end_ns = 0
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.forced = 0

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def add(self, rec: SpanRecord) -> None:
        if len(self.records) == SPAN_CAPACITY:
            self.n_dropped += 1
            self.dropped_end_ns = max(self.dropped_end_ns,
                                      self.records[0].end_ns)
        self.records.append(rec)


_STORE = _Store()
_NULL = contextlib.nullcontext()


def is_recording() -> bool:
    """Whether a span opened now records: never while exporting; else
    inside :func:`recording` or while a ``torch.profiler`` profile is
    active on the thread."""
    if exportable.exporting():
        return False
    return _STORE.forced > 0 or torch._C._autograd._profiler_enabled()


class _Span:
    """A recording span; under a profiler also an :func:`annotate` range
    (``ranged``)."""

    __slots__ = ("name", "id", "parent", "solve", "start_ns", "_range")

    def __init__(self, name: str, ranged: bool = True):
        self.name = name
        self._range = (annotate(name) if ranged
                       and torch._C._autograd._profiler_enabled() else None)

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        st = _STORE.stack()
        self.id = next(_STORE.ids)
        self.parent, outer_solve = st[-1] if st else (0, 0)
        self.solve = outer_solve or (self.id if self.name == "solve" else 0)
        st.append((self.id, self.solve))
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        st = _STORE.stack()
        if st and st[-1][0] == self.id:
            st.pop()
        _STORE.add(SpanRecord(self.name, self.start_ns, end_ns, self.id,
                              self.parent, self.solve))
        return False


def span(name: str):
    """A context manager around one layer's work (see the module): a
    recorded span while spans record, else a shared null context (while
    exporting a fresh ``contextlib.nullcontext``, which Dynamo traces)."""
    if exportable.exporting():
        return contextlib.nullcontext()
    if _STORE.forced or torch._C._autograd._profiler_enabled():
        return _Span(name)
    return _NULL


def spanned(name: str):
    """A decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    _STORE.forced += 1
    try:
        yield
    finally:
        _STORE.forced -= 1


def spans() -> List[SpanRecord]:
    """The kept records, oldest first."""
    return list(_STORE.records)


def dropped() -> Dropped:
    """The records the store has dropped (see :class:`Dropped`)."""
    return Dropped(_STORE.n_dropped, _STORE.dropped_end_ns)


def _gc_span(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: one ``gc`` span per collection, in memory
    only: a collection can start inside a tracer (``make_fx``, Dynamo),
    which would take a profiler range for an op of its graph."""
    local = _STORE.local
    if phase == "start":
        local.gc = (_Span("gc", ranged=False).__enter__() if is_recording()
                    else None)
    elif getattr(local, "gc", None) is not None:
        g, local.gc = local.gc, None
        g.__exit__(None, None, None)


gc.callbacks.append(_gc_span)


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

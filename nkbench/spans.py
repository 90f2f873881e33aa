"""Per-layer numbers from the program's own spans.

The port records a span at each layer boundary while a ``torch.profiler``
profile is active or inside ``profiling.recording()``
(``newtonkrylov_tpu_torch.utils.profiling``): ``(name, start_ns, end_ns,
id, parent, solve)`` in ``time.time_ns()``, the clock of the profiler's
timestamps.  Two sources feed the readers:

* **the window** (:func:`window`): in a ``--trace 1`` run the harness's
  profiler is active over the window, so the program records there; the
  ``solve`` spans that start inside ``run.window_ns`` and the spans under
  them;
* **one traced solve after the window** (:func:`replay`): one live solve
  of the cell's system from ``run.u0()`` under a CPU and CUDA profile,
  made again (up to :data:`ATTEMPTS` solves) while it gives no result,
  cached per run.  Each profile opens with :data:`PRIMER` small kernels,
  synchronized, and only the events after them are read.  Each device
  event is put down to the span its launch fell in, by the runtime
  launch's correlation id (or, for a copy the runtime did not report, the
  launching operator's); the card's idle time inside the solve is split at
  span boundaries and each piece given to the innermost span open over
  it.  The replay prints a table of idle and busy device ms by innermost
  span to standard error.

A reader gives no result, and logs why, where the program records no span
(an older checkout), where the store dropped a span of the window, and for
the replay where there is no card, where its counts differ from the
window's, or where the profiler returned fewer kernels than launches
(ROADMAP item 28(a)).
"""

from __future__ import annotations

import bisect
import re
import statistics
import time
from collections import defaultdict
from typing import (Dict, Iterable, List, NamedTuple, Optional, Sequence,
                    Tuple)

Interval = Tuple[int, int]

RUNTIME = re.compile(r"^cu(da)?[A-Z]")        # CUDA runtime / driver calls
LAUNCH = re.compile(r"^cu(da)?Launch\w*Kernel")
COPY = ("Memcpy", "Memset")
NO_LAYER = ("solve", "outer")  # innermost spans that name no layer
# traced solves a run makes before the replay's readers give no result:
# the profiler now and then loses the records of a session's first kernels
# (ROADMAP item 28(a); ``run.py`` keeps CUPTI between sessions, which
# cures most of it), and a short list is refused, not used
ATTEMPTS = 5
# small kernels each replay's profile runs before its solve: where the
# profiler loses a session's first kernel records, it loses these; events
# are read from the middle of the gap between them and the solve, which
# leaves room for the profiler's clock to stray from time.time_ns()
PRIMER = 16
PRIMER_GAP_S = 0.004


# -- the program's span API ---------------------------------------------------
def program_spans():
    """``newtonkrylov_tpu_torch.utils.profiling`` where it records spans,
    else None."""
    try:
        from newtonkrylov_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, a) for a in ("spans", "recording",
                                               "dropped")):
        return None
    return profiling


# -- interval arithmetic ------------------------------------------------------
def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals as a sorted list of disjoint ones."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def length(intervals: Sequence[Interval]) -> int:
    return sum(b - a for a, b in intervals)


def clip(intervals: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def intersect(a: Sequence[Interval], b: Sequence[Interval]
              ) -> List[Interval]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def minus(base: Interval, holes: Sequence[Interval]) -> List[Interval]:
    """``base`` less a sorted list of disjoint ``holes``."""
    out, cur = [], base[0]
    for a, b in clip(holes, *base):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < base[1]:
        out.append((cur, base[1]))
    return out


# -- the span tree ------------------------------------------------------------
class Tree:
    """Spans under their parents (records with ``name``, ``start_ns``,
    ``end_ns``, ``id``, ``parent``, ``solve``)."""

    def __init__(self, records: Sequence):
        self.by_id = {r.id: r for r in records}
        self.children: Dict[int, list] = defaultdict(list)
        for r in records:
            if r.parent in self.by_id:
                self.children[r.parent].append(r)

    def self_ns(self, r) -> int:
        """``r``'s length less the union of its children's intervals."""
        kids = union((c.start_ns, c.end_ns) for c in self.children[r.id])
        return length(minus((r.start_ns, r.end_ns), kids))

    def own(self) -> List[Tuple[int, int, int]]:
        """``(start, end, id)``, sorted: the times at which each span is
        the innermost one open (its interval less its children's)."""
        out = []
        for r in self.by_id.values():
            kids = union((c.start_ns, c.end_ns) for c in self.children[r.id])
            out += [(a, b, r.id) for a, b in minus((r.start_ns, r.end_ns),
                                                   kids)]
        return sorted(out)

    def within(self, r, name: str) -> bool:
        """Whether ``r`` is a span ``name`` or lies under one."""
        while r is not None:
            if r.name == name:
                return True
            r = self.by_id.get(r.parent)
        return False


class Innermost:
    """The innermost span open at a time, from :meth:`Tree.own`."""

    def __init__(self, tree: Tree):
        self.tree, self.own = tree, tree.own()
        self.starts = [o[0] for o in self.own]

    def at(self, t: int):
        k = bisect.bisect_right(self.starts, t) - 1
        if k >= 0 and self.own[k][0] <= t < self.own[k][1]:
            return self.tree.by_id[self.own[k][2]]
        return None

    def split(self, intervals: Sequence[Interval]) -> Dict[str, int]:
        """ns of sorted disjoint ``intervals`` by the name of the innermost
        span open over each piece (``"no span"`` outside every span)."""
        out: Dict[str, int] = defaultdict(int)
        for name in {self.tree.by_id[sid].name for _, _, sid in self.own}:
            out[name] = length(intersect(intervals, self.of(name)))
        rest = length(intervals) - sum(out.values())
        if rest:
            out["no span"] = rest
        return {k: v for k, v in out.items() if v}

    def of(self, *names: str) -> List[Interval]:
        """The sorted times at which a span of ``names`` is innermost."""
        return [(a, b) for a, b, sid in self.own
                if self.tree.by_id[sid].name in names]


def solves_in(records: Sequence, window: Interval):
    """The top-level ``solve`` spans that start in ``window`` and every
    record of theirs: ``(solves, records)``."""
    w0, w1 = window
    solves = [r for r in records if r.name == "solve" and r.solve == r.id
              and w0 <= r.start_ns < w1]
    ids = {s.id for s in solves}
    return solves, [r for r in records if r.solve in ids]


def lost(dropped, window: Interval) -> bool:
    """Whether the store dropped a span that ended inside or after
    ``window``'s start."""
    return dropped.count > 0 and dropped.newest_end_ns >= window[0]


def median_ms(values_ns: Sequence[int]) -> Optional[float]:
    return statistics.median(values_ns) / 1e6 if values_ns else None


# -- (a) the window -----------------------------------------------------------
class Window(NamedTuple):
    solves: list
    records: list
    tree: Tree

    def named(self, name: str) -> list:
        return [r for r in self.records if r.name == name]


def window_of(records: Sequence, window: Interval) -> Optional[Window]:
    solves, recs = solves_in(records, window)
    if not solves:
        return None
    return Window(solves, recs, Tree(recs))


def window(run) -> Optional[Window]:
    """The window's solves and their spans (see the module), or None."""
    prof = program_spans()
    if prof is None:
        run.log("[spans] the program records no span")
        return None
    if lost(prof.dropped(), run.window_ns):
        run.log(f"[spans] the span store dropped {prof.dropped().count} "
                "spans, some in the window: no result")
        return None
    w = window_of(prof.spans(), run.window_ns)
    if w is None:
        run.log("[spans] no solve span in the window")
    return w


def linearize_span_ms(w: Window) -> Optional[float]:
    return median_ms([r.end_ns - r.start_ns for r in w.named("linearize")])


def outer_self_ms(w: Window) -> Optional[float]:
    return median_ms([w.tree.self_ns(r) for r in w.named("outer")])


def gc_ms(w: Window) -> float:
    return sum(r.end_ns - r.start_ns for r in w.named("gc")) / 1e6 / len(
        w.solves)


def host_reads(w: Window) -> float:
    return len(w.named("read")) / len(w.solves)


def from_window(run, fn):
    w = window(run)
    return None if w is None else fn(w)


# -- (b) one traced solve after the window ------------------------------------
class Device(NamedTuple):
    """A device event of the profiler."""
    name: str
    start_ns: int
    end_ns: int
    corr: int     # the runtime call's correlation id
    linked: int   # the launching operator's correlation id


class Replay(NamedTuple):
    solve: object           # the solve span
    tree: Tree
    inner: Innermost
    idle_iv: List[Interval]  # the card's idle intervals inside the solve
    idle: Dict[str, int]    # idle ns by innermost span name
    busy: Dict[str, int]    # device ns by the innermost span of the launch
    device_ns: Dict[int, int]  # device ns by launching span id
    unattributed_ns: int


def attribute(inner: Innermost, devices: Sequence[Device],
              launch_ns: Dict[int, int], op_ns: Dict[int, int]
              ) -> Tuple[Dict[int, int], int]:
    """Device ns by the innermost span open at each event's launch: the
    runtime call of the same correlation id, else the operator the event
    is linked to.  Returns (ns by span id, ns put down to no span)."""
    out: Dict[int, int] = defaultdict(int)
    none = 0
    for d in devices:
        t = launch_ns.get(d.corr, op_ns.get(d.linked))
        r = inner.at(t) if t is not None else None
        if r is None:
            none += d.end_ns - d.start_ns
        else:
            out[r.id] += d.end_ns - d.start_ns
    return dict(out), none


def reduce_replay(records: Sequence, devices: Sequence[Device],
                  launch_ns: Dict[int, int], op_ns: Dict[int, int]
                  ) -> Optional[Replay]:
    """The replayed solve's idle and busy time by span (see the module)."""
    solves = [r for r in records if r.name == "solve" and r.solve == r.id]
    if len(solves) != 1:
        return None
    solve = solves[0]
    recs = [r for r in records if r.solve == solve.id]
    tree = Tree(recs)
    inner = Innermost(tree)
    s0, s1 = solve.start_ns, solve.end_ns
    busy_iv = clip(union((d.start_ns, d.end_ns) for d in devices), s0, s1)
    idle_iv = minus((s0, s1), busy_iv)
    by_id, none = attribute(inner, devices, launch_ns, op_ns)
    busy: Dict[str, int] = defaultdict(int)
    for sid, ns in by_id.items():
        busy[tree.by_id[sid].name] += ns
    return Replay(solve, tree, inner, idle_iv, inner.split(idle_iv),
                  dict(busy), by_id, none)


def device_ms_in(rep: Replay, name: str) -> Optional[float]:
    """Device ms of the events launched inside ``name`` spans, over those
    spans."""
    spans = [r for r in rep.tree.by_id.values() if r.name == name]
    if not spans:
        return None
    ns = sum(v for sid, v in rep.device_ns.items()
             if rep.tree.within(rep.tree.by_id[sid], name))
    return ns / 1e6 / len(spans)


def idle_share_pct(rep: Replay, name: str) -> Optional[float]:
    total = sum(rep.idle.values())
    return 100.0 * rep.idle.get(name, 0) / total if total else None


def kineto(events) -> Tuple[List[Device], Dict[int, int], Dict[int, int],
                            int, int, list, list]:
    """The raw profiler events as (device events, launch ns by correlation
    id, operator start ns by correlation id, kernels, kernel launches,
    operator intervals ``(start, end, name)``, kernel launches with no
    device event of their correlation id by :func:`orphans`)."""
    from torch.autograd import DeviceType

    devices, launch_ns, op_ns, ops, calls = [], {}, {}, [], []
    kernels = launches = 0
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            devices.append(Device(name, e.start_ns(), e.end_ns(),
                                  e.correlation_id(),
                                  e.linked_correlation_id()))
            kernels += not name.startswith(COPY)
        elif RUNTIME.match(name):
            launch_ns[e.correlation_id()] = e.start_ns()
            if LAUNCH.match(name):
                launches += 1
                calls.append((e.correlation_id(), name, e.start_ns()))
        elif not e.is_user_annotation():
            op_ns[e.correlation_id()] = e.start_ns()
            ops.append((e.start_ns(), e.end_ns(), name))
    return (devices, launch_ns, op_ns, kernels, launches, ops,
            orphans(calls, {d.corr for d in devices}, ops))


def orphans(calls: Sequence[Tuple[int, str, int]], seen: set,
            ops: Sequence[Tuple[int, int, str]], most: int = 64
            ) -> List[Tuple[str, int]]:
    """Kernel launches ``(correlation id, name, ns)`` whose correlation id
    no device event carries, as ``("<launch> in <operator>", ns)`` (the
    innermost operator open at the launch; the first ``most`` looked up)."""
    out = []
    for k, (corr, name, t) in enumerate(c for c in calls if c[0] not in seen):
        op = "?"
        if k < most:
            open_ops = [o for o in ops if o[0] <= t <= o[1]]
            op = max(open_ops)[2] if open_ops else "no operator"
        out.append((f"{name} in {op}", t))
    return out


def host_work(rep: Replay, ops: Sequence[Tuple[int, int, str]],
              top: int = 8) -> List[Tuple[str, int]]:
    """ns of the host operators ``(start, end, name)`` over the card's idle
    time whose innermost span is ``solve`` or ``outer``, by name, most
    first (nested operators each count)."""
    gaps = intersect(rep.idle_iv, rep.inner.of(*NO_LAYER))
    starts = [a for a, _ in gaps]
    out: Dict[str, int] = defaultdict(int)
    for a, b, name in ops:
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        while k < len(gaps) and gaps[k][0] < b:
            out[name] += max(0, min(b, gaps[k][1]) - max(a, gaps[k][0]))
            k += 1
    return sorted(((n, v) for n, v in out.items() if v),
                  key=lambda x: -x[1])[:top]


def _table(log, rep: Replay, ops: list) -> None:
    idle_total = sum(rep.idle.values())
    names = sorted(set(rep.idle) | set(rep.busy),
                   key=lambda n: -rep.idle.get(n, 0))
    wall_ms = (rep.solve.end_ns - rep.solve.start_ns) / 1e6
    log(f"[spans] replayed solve {wall_ms:.3f} ms; device idle "
            f"{idle_total / 1e6:.3f} ms; by the "
            f"innermost span (idle: the host's span over the gap; busy: the "
            f"span that launched the work):")
    log(f"[spans]   {'span':16s} {'idle ms':>12s} {'idle %':>8s} "
            f"{'busy ms':>12s}")
    for n in names:
        i = rep.idle.get(n, 0)
        log(f"[spans]   {n:16s} {i / 1e6:12.3f} "
                f"{100.0 * i / max(idle_total, 1):8.2f} "
                f"{rep.busy.get(n, 0) / 1e6:12.3f}")
    no_layer = sum(rep.idle.get(n, 0) for n in NO_LAYER)
    log(f"[spans] idle in no layer (innermost 'solve' or 'outer'): "
            f"{no_layer / 1e6:.3f} ms, "
            f"{100.0 * no_layer / max(idle_total, 1):.2f}%; device ms put "
            f"down to no span {rep.unattributed_ns / 1e6:.3f}")
    work = host_work(rep, ops)
    if work:
        log("[spans] host operators over that idle time (ms): " + ", ".join(
            f"{n} {ns / 1e6:.3f}" for n, ns in work))


def _replayable(run) -> bool:
    """Whether :func:`replay` solves (a card, the program's spans, one
    rank, a request in the window); logs why not."""
    if not run.cuda:
        run.log("[spans] no card: no replayed solve")
        return False
    if program_spans() is None:
        run.log("[spans] the program records no span: no replayed solve")
        return False
    if getattr(run, "world", 1) > 1:
        run.log("[spans] a run over ranks makes no replayed solve")
        return False
    return bool(run.records)


def _traced_solve(run) -> Optional[Replay]:
    """One traced solve (see the module); None, logged, where it gives no
    result."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = program_spans()
    u0 = run.u0(run.system.state_dtype())
    torch.cuda.synchronize(run.device)
    with prof.recording(), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as p:
        primer = torch.zeros(1, device=run.device)
        for _ in range(PRIMER):
            primer.add_(1.0)
        torch.cuda.synchronize(run.device)
        primed = time.time_ns()
        time.sleep(PRIMER_GAP_S)
        mark = time.time_ns()
        ans = run.system(u0)
        torch.cuda.synchronize(run.device)
    counts = {(r.outer, r.inner) for r in run.records}
    if (ans.outer, ans.inner) not in counts:
        run.log(f"[spans] the replayed solve took {ans.outer} / {ans.inner}, "
                f"the window's {sorted(counts)}: no result")
        return None
    if lost(prof.dropped(), (mark, time.time_ns())):
        run.log("[spans] the span store dropped spans of the replayed "
                "solve: no result")
        return None
    run.log(f"[spans] replayed solve {ans.outer} / {ans.inner}")
    return from_events(p.profiler.kineto_results.events(),
                       [r for r in prof.spans() if r.start_ns >= mark],
                       run.log, since=(primed + mark) // 2)


def _orphan_log(log, lone, devices, records) -> None:
    """Where the launches with no device event fell: the innermost span,
    and ms after the first device event and after the solve's start."""
    first = min((d.start_ns for d in devices), default=0)
    solves = [r for r in records if r.name == "solve" and r.solve == r.id]
    inner = Innermost(Tree(records)) if records else None
    s0 = solves[0].start_ns if solves else first
    ranked = sorted({(d.start_ns, d.corr) for d in devices})
    log(f"[spans] {len(lone)} kernel launches with no device event:")
    for label, t in lone[:16]:
        r = inner.at(t) if inner is not None else None
        before = bisect.bisect_left(ranked, (t, -1))
        log(f"[spans]   {label}: span {r.name if r else 'none'}, "
            f"{(t - s0) / 1e6:.3f} ms into the solve, "
            f"{(t - first) / 1e6:.3f} ms after the first device event, "
            f"{before} device events start before it")


def from_events(events, records: Sequence, log, since: int = 0
                ) -> Optional[Replay]:
    """The :class:`Replay` of one traced solve from the profiler's raw
    events that start at ``since`` or later and the solve's span records;
    None, logged, where the profiler returned fewer kernels than launches
    or the records hold no single solve."""
    devices, launch_ns, op_ns, kernels, launches, ops, lone = kineto(
        [e for e in events if e.start_ns() >= since])
    log(f"[spans] {len(devices)} device events, {kernels} kernels, "
        f"{launches} kernel launches")
    if lone:
        _orphan_log(log, lone, devices, records)
    if kernels < launches:
        log("[spans] the profiler returned fewer kernels than launches: no "
            "result")
        return None
    rep = reduce_replay(records, devices, launch_ns, op_ns)
    if rep is None:
        log("[spans] no single solve span among the records: no result")
        return None
    _table(log, rep, ops)
    return rep


def replay(run) -> Optional[Replay]:
    """The traced solve after the window, made once a run (see the
    module)."""
    if not hasattr(run, "_span_replay"):
        run._span_replay = None
        for _ in range(ATTEMPTS if _replayable(run) else 0):
            run._span_replay = _traced_solve(run)
            if run._span_replay is not None:
                break
    return run._span_replay


def from_replay(run, fn):
    rep = replay(run)
    return None if rep is None else fn(rep)

"""The device's timeline over the measured window, from ``torch.profiler``.

Only the card's own activity is recorded (``ProfilerActivity.CUDA``): its
kernels, copies and fills.  The profiler's raw events are read directly;
turning a million of them into ``FunctionEvent`` objects would take
minutes.  From them, over the window (from the first request's start to
the synchronize after the last):

* ``busy_s`` over ``window_s``: the length of the union of the device
  events' intervals, so events that overlap (two streams) count once,
  over the window's length.  The harness's own work between requests
  (making u₀, copying answers out) and an open loop's waits for the next
  request are in the window;
* ``request_busy_s`` over ``request_s``: the same union inside the
  harness's "request" spans (from a call to the synchronize after it)
  over their summed length: how much of a request's own time the card
  works;
* ``by_name``: device seconds and event counts by the profiler's names;
* ``gaps``: the longest gaps without a device event, each labelled by the
  harness span open where it starts and by the device events on either
  side.

The spans are stamped with ``time.time_ns()``, the clock of the
profiler's timestamps.

:meth:`Timeline.check` refuses a timeline with fewer device events than a
count the harness knows (one per request at least, and one per kernel
launch the program counted): the profiler can drop events late in a long
run, and a short list would under-read the busy time.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Spans:
    """The harness's own spans, in the profiler's clock."""

    def __init__(self):
        self.items: List[Span] = []

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        self.items.append(Span(name, start_ns, end_ns))


def now_ns() -> int:
    return time.time_ns()


class Timeline(NamedTuple):
    events: int        # device events in the window
    busy_s: float
    window_s: float
    request_busy_s: float
    request_s: float
    by_name: Dict[str, Tuple[float, int]]
    gaps: List[Tuple[str, float]]

    def check(self, at_least: int, why: str) -> None:
        self.check_count(self.events, at_least, why)

    @staticmethod
    def check_count(events: int, at_least: int, why: str) -> None:
        if events < at_least:
            raise RuntimeError(
                f"the profiler returned {events} device events, fewer "
                f"than the {at_least} the run must have made ({why}): the "
                f"trace is short and its busy time would under-read")

    def check_kernel(self, events: int, calls: int, name: str) -> None:
        """A kernel's events against the calls the program counted."""
        self.check_count(events, calls, f"one '{name}' event a call")

    def kernel_seconds(self, fragment: str) -> Tuple[float, int]:
        """Device seconds and events of the names containing ``fragment``."""
        s, k = 0.0, 0
        for name, (sec, cnt) in self.by_name.items():
            if fragment in name:
                s, k = s + sec, k + cnt
        return s, k

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((n, s) for n, (s, _) in self.by_name.items()),
                     key=lambda x: -x[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:top]]}


def _short(name: str, width: int = 80) -> str:
    """A kernel's name without its namespaces and argument list."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(noise, "")
    if not name.startswith(("Memcpy", "Memset")):
        name = name.split("(", 1)[0]
    return name if len(name) <= width else name[:width - 3] + "..."


def _overlap(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce(iv: List[Tuple[int, int, str]], spans: Spans,
           window: Tuple[int, int], top: int = 10) -> Timeline:
    """A :class:`Timeline` of device intervals ``(start_ns, end_ns, name)``
    over ``window`` (``(start_ns, end_ns)``), each interval cut to it."""
    w0, w1 = window
    cut = sorted((max(a, w0), min(b, w1), name) for a, b, name in iv
                 if b > w0 and a < w1)
    opened = sorted((sp.start_ns, sp.name) for sp in spans.items)
    starts = [o[0] for o in opened]

    def span_at(t: int) -> str:
        k = bisect.bisect_right(starts, t) - 1
        return opened[k][1] if k >= 0 else "the window's start"

    by_name: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    merged: List[Tuple[int, int]] = []
    gaps: List[Tuple[int, str]] = []
    cur_end, cur_name = w0, "the window's start"
    for start, end, name in cut:
        rec = by_name[name]
        rec[0] += (end - start) / 1e9
        rec[1] += 1
        if start > cur_end:
            gaps.append((start - cur_end, f"{span_at(cur_end)}: "
                         f"{_short(cur_name)} -> {_short(name)}"))
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
        if end > cur_end:
            cur_end, cur_name = end, name
    if w1 > cur_end:
        gaps.append((w1 - cur_end, f"{span_at(cur_end)}: "
                     f"{_short(cur_name)} -> the window's end"))
    gaps.sort(key=lambda g: -g[0])
    requests = sorted((sp.start_ns, sp.end_ns) for sp in spans.items
                      if sp.name == "request")
    return Timeline(len(cut), sum(b - a for a, b in merged) / 1e9,
                    (w1 - w0) / 1e9, _overlap(merged, requests) / 1e9,
                    sum(b - a for a, b in requests) / 1e9,
                    {k: (v[0], v[1]) for k, v in by_name.items()},
                    [(label, length / 1e9) for length, label in gaps[:top]])


def timeline(prof, spans: Spans, window: Tuple[int, int],
             top: int = 10) -> Timeline:
    """Reduce a finished profiler's device events to a :class:`Timeline`."""
    from torch.autograd import DeviceType

    iv = [(e.start_ns(), e.end_ns(), e.name())
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    return reduce(iv, spans, window, top=top)


class Recorder:
    """``with Recorder(on) as rec:`` profiles the card's activity while
    ``on``; ``rec.result(spans, window)`` reduces it afterwards."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def result(self, spans: Spans, window: Tuple[int, int]
               ) -> Optional[Timeline]:
        if self.prof is None:
            return None
        return timeline(self.prof, spans, window)

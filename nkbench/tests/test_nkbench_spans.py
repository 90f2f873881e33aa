"""The span readers' reductions on synthetic spans and device events, and
the window readers on a small solve the program records on the CPU."""
import time
from typing import NamedTuple

import pytest
import torch
from torch.autograd import DeviceType

from nkbench import spans, spec


class Rec(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    solve: int


class Run:
    """What a reader is handed, as far as the span readers look."""

    def __init__(self, window_ns=(0, 0), cuda=False):
        self.window_ns, self.cuda = window_ns, cuda
        self.records, self.lines = [], []

    def log(self, line):
        self.lines.append(line)


def _solve(base, sid):
    """A solve at ``base`` with ids from ``sid``: setup, one outer holding
    a linearize (with a collection inside) and a krylov with a read, and
    two reads."""
    s = sid
    return [Rec("solve", base, base + 100, s, 0, s),
            Rec("read", base + 5, base + 6, s + 1, s, s),
            Rec("outer", base + 10, base + 90, s + 2, s, s),
            Rec("linearize", base + 12, base + 40, s + 3, s + 2, s),
            Rec("gc", base + 20, base + 25, s + 4, s + 3, s),
            Rec("krylov", base + 45, base + 80, s + 5, s + 2, s),
            Rec("read", base + 70, base + 71, s + 6, s + 5, s),
            Rec("read", base + 92, base + 93, s + 7, s, s)]


def test_window_takes_the_solves_that_start_in_it():
    recs = (_solve(0, 1) + _solve(1000, 11) + _solve(2000, 21)
            + [Rec("gc", 1500, 1510, 31, 0, 0)])
    w = spans.window_of(recs, (900, 2000))
    assert [s.id for s in w.solves] == [11]
    assert {r.solve for r in w.records} == {11}
    assert spans.host_reads(w) == 3
    assert spans.gc_ms(w) == pytest.approx(5e-6)
    assert spans.linearize_span_ms(w) == pytest.approx(28e-6)
    # the outer: 80 ns less its children's union (linearize 28, krylov 35)
    assert spans.outer_self_ms(w) == pytest.approx(17e-6)
    assert spans.window_of(recs, (3000, 4000)) is None
    w2 = spans.window_of(recs, (0, 3000))
    assert len(w2.solves) == 3 and spans.host_reads(w2) == 3


def test_self_time_counts_overlapping_children_once():
    recs = [Rec("outer", 0, 100, 1, 0, 1), Rec("a", 10, 50, 2, 1, 1),
            Rec("b", 40, 60, 3, 1, 1), Rec("c", 90, 120, 4, 1, 1)]
    tree = spans.Tree(recs)
    # children cover 10..60 and 90..100 inside the outer
    assert tree.self_ns(recs[0]) == 100 - 50 - 10
    assert tree.self_ns(recs[1]) == 40


def test_idle_goes_to_the_innermost_open_span():
    recs = _solve(0, 1)
    # the card is busy 0..15, 30..50 and 85..100 of the solve's 0..100
    devices = [spans.Device("k", a, b, c, 0)
               for a, b, c in ((0, 15, 1), (30, 50, 2), (85, 100, 3))]
    rep = spans.reduce_replay(recs, devices, {1: 1, 2: 13, 3: 46}, {})
    assert rep.idle_iv == [(15, 30), (50, 85)]
    # 15..30: linearize 15..20, gc 20..25, linearize 25..30; 50..85:
    # krylov 50..70, read 70..71, krylov 71..80, outer 80..85
    assert rep.idle == {"linearize": 10, "gc": 5, "krylov": 29, "read": 1,
                        "outer": 5}
    assert spans.idle_share_pct(rep, "linearize") == pytest.approx(20.0)
    # launches at 1 (solve), 13 (linearize), 46 (krylov)
    assert rep.busy == {"solve": 15, "linearize": 20, "krylov": 15}
    assert spans.device_ms_in(rep, "krylov") == pytest.approx(15e-6)
    assert spans.device_ms_in(rep, "outer") == pytest.approx(35e-6)
    assert spans.device_ms_in(rep, "accept") is None


def test_kernels_follow_their_launch_by_correlation_id():
    recs = _solve(0, 1)
    inner = spans.Innermost(spans.Tree(recs))
    devices = [spans.Device("k1", 50, 60, 7, 100),   # launched at 46
               spans.Device("copy", 60, 61, 8, 101),  # no runtime call
               spans.Device("k3", 61, 62, 9, 102)]   # nothing known
    by_id, none = spans.attribute(inner, devices, {7: 46}, {101: 21})
    assert by_id == {6: 10, 5: 1} and none == 1  # krylov, gc


class Ev:
    """A raw profiler event, as far as ``spans.kineto`` reads one."""

    def __init__(self, name, dev, start, end, corr, linked=0, ann=False):
        self._v = (name, dev, start, end, corr, linked, ann)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def end_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def is_user_annotation(self): return self._v[6]


def _events(drop_kernel=False):
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    ev = [Ev("aten::mul", cpu, 12, 14, 2), Ev("solve", cpu, 0, 100, 1,
                                               ann=True),
          Ev("cudaLaunchKernel", cpu, 13, 14, 48, 2),
          Ev("kernel_a", cuda, 30, 50, 48, 2),
          Ev("solve", cuda, 30, 50, 1, ann=True),
          Ev("aten::add", cpu, 46, 47, 3),
          Ev("cuLaunchKernel", cpu, 46, 47, 49, 3),
          Ev("kernel_b", cuda, 85, 100, 49, 3),
          Ev("Memcpy HtoD (Pageable -> Device)", cuda, 0, 15, 60, 3)]
    if drop_kernel:
        ev = [e for e in ev if e.name() != "kernel_b"]
    return ev


def test_events_reduce_to_a_replay_and_refuse_a_short_list():
    recs = _solve(0, 1)
    log = []
    rep = spans.from_events(_events(), recs, log.append)
    assert rep.busy == {"linearize": 20, "krylov": 30}  # copy: aten::add
    assert rep.idle_iv == [(15, 30), (50, 85)]
    assert any("idle in no layer" in line for line in log)
    short = _events(drop_kernel=True)
    assert spans.from_events(short, recs, log.append) is None
    assert "fewer kernels than launches" in log[-1]
    assert spans.from_events(_events(), [], log.append) is None


def test_events_before_the_solve_are_not_read():
    """A launch of the replay's primer, before ``since``, whose kernel
    record the profiler lost, does not make the list short."""
    cpu = DeviceType.CPU
    ev = [Ev("aten::add_", cpu, -9, -8, 90),
          Ev("cudaLaunchKernel", cpu, -9, -8, 91, 90)] + _events()
    log = []
    assert spans.from_events(ev, _solve(0, 1), log.append, since=-9) is None
    rep = spans.from_events(ev, _solve(0, 1), log.append, since=-1)
    assert rep.busy == {"linearize": 20, "krylov": 30}


def test_a_launch_with_no_device_event_is_named_where_it_fell():
    log = []
    spans.from_events(_events(drop_kernel=True), _solve(0, 1), log.append)
    said = [line for line in log if "cuLaunchKernel in aten::add" in line]
    assert len(said) == 1 and "span krylov" in said[0]
    assert "2 device events start before it" in said[0]


@pytest.mark.parametrize("short", [0, 2, 3])
def test_a_short_replay_is_traced_again(monkeypatch, short):
    """The replay refuses a short list and traces the solve again, up to
    ATTEMPTS solves; a run over ranks makes none."""
    calls = []

    def traced(run):
        calls.append(run)
        return None if len(calls) <= short else "replay"

    monkeypatch.setattr(spans, "_traced_solve", traced)
    run = Run(cuda=True)
    run.records = [object()]
    got = spans.replay(run)
    assert len(calls) == min(short + 1, spans.ATTEMPTS)
    assert got == (None if short >= spans.ATTEMPTS else "replay")
    assert spans.replay(run) is got and len(calls) <= spans.ATTEMPTS
    ranked = Run(cuda=True)
    ranked.records, ranked.world = [object()], 4
    assert spans.replay(ranked) is None and "over ranks" in ranked.lines[-1]


def test_host_work_over_idle_time_in_no_layer():
    recs = _solve(0, 1)
    devices = [spans.Device("k", 0, 15, 1, 0)]
    rep = spans.reduce_replay(recs, devices, {1: 1}, {})
    # the card idles 15..100; of it the outer is innermost over 40..45 and
    # 80..90, the solve over 90..92 and 93..100
    ops = [(80, 95, "aten::item"), (0, 4, "aten::empty")]
    work = dict(spans.host_work(rep, ops))
    assert work == {"aten::item": 14}


def test_no_spans_no_result(monkeypatch):
    run = Run(window_ns=(1, 2))
    assert spans.window(run) is None
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    for name in ("linearize_span_ms", "outer_self_ms", "gc_ms", "host_reads",
                 "idle_linearize_pct", "accept_span_ms", "precond_span_ms"):
        run = Run(window_ns=(0, time.time_ns()), cuda=True)
        run.records = [object()]
        assert spec.reader("per_layer", name).read(run) is None
        assert run.lines


def test_window_readers_on_a_recorded_solve():
    """A 32² df32 flagship recorded on the CPU: the window readers read
    its spans, and the reads are (outers + 1) + (inners + outers)."""
    import newtonkrylov_tpu_torch as nkt
    from newtonkrylov_tpu_torch.fftprec import fft_poisson
    from newtonkrylov_tpu_torch.problems import bratu2d as tb
    from newtonkrylov_tpu_torch.utils import profiling

    p = tb.default_config(32, lam=6.0)
    u0 = tb.initial_guess(32, dtype=torch.float64, device="cpu")
    w0 = time.time_ns()
    with profiling.recording():
        _, info = nkt.newton_krylov_jit(
            tb.residual_scaled, u0, p, algo="cg", tol_rel=1e-8,
            krylov_dtype=torch.float32, residual_df=tb.residual_scaled_df,
            M=fft_poisson(precision="high"), precond_refresh="once")
    run = Run(window_ns=(w0, time.time_ns()))
    o, i = int(info.stats.outer_iterations), int(info.stats.inner_iterations)
    got = {name: spec.reader("per_layer", name).read(run)
           for name in ("linearize_span_ms", "outer_self_ms", "gc_ms",
                        "host_reads", "idle_linearize_pct")}
    assert got["host_reads"] == (o + 1) + (i + o)
    assert got["linearize_span_ms"] > 0 and got["outer_self_ms"] >= 0
    assert got["gc_ms"] >= 0
    assert got["idle_linearize_pct"] is None  # no card: no replay
    assert any("no card" in line for line in run.lines)

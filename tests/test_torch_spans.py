"""The program's spans (``utils/profiling.py``: ``span``, ``recording``,
``spans``) on the CPU.

With spans off the program runs as it did before them: nothing records,
``span`` hands back one shared null context, the solvers receive the
operator and preconditioner objects themselves, and an export traces the
same graph.  With spans on, a small df32 Bratu solve records the layers'
spans with the counts its iteration counts fix, each inside its parent and
all under one solve id, and its iterates, counts and history are those of
the solve without spans, bit for bit.  A time measured here is the CPU's.
"""

import gc
import time
from collections import Counter

import pytest
import torch

import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu_torch import newton, solvers
from newtonkrylov_tpu_torch.fftprec import fft_poisson
from newtonkrylov_tpu_torch.operator import JacobianOperator
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.utils import profiling, serving

DRIVERS = {"jit": nkt.newton_krylov_jit, "host": nkt.newton_krylov}


def _flagship(driver, n=32, lam=6.0):
    """The df32 flagship at side ``n``: f32 CG, ``fft_poisson`` built once;
    returns (state, outers, inners, history or None)."""
    p = tb.default_config(n, lam=lam)
    u0 = tb.initial_guess(n, dtype=torch.float64, device="cpu")
    u, info = DRIVERS[driver](
        tb.residual_scaled, u0, p, algo="cg", tol_rel=1e-8, max_niter=20,
        krylov_dtype=torch.float32, residual_df=tb.residual_scaled_df,
        M=fft_poisson(precision="high"), precond_refresh="once")
    return (u, int(info.stats.outer_iterations),
            int(info.stats.inner_iterations), info.history)


def _since(mark_ns, names=None):
    return [r for r in profiling.spans() if r.start_ns >= mark_ns
            and (names is None or r.name in names)]


def test_off_records_nothing_and_hands_back_one_null_context():
    assert not profiling.is_recording()
    a, b = profiling.span("solve"), profiling.span("outer")
    assert a is b
    with a:
        pass
    before = profiling.spans()
    _flagship("jit", n=16)
    assert profiling.spans() == before


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_recorded_solve_spans(driver):
    """One ``solve``; ``outer``, ``krylov`` and ``accept`` once an outer;
    ``linearize`` once an outer and once for the static preconditioner;
    ``linearize.trace`` once, in the set-up;
    ``read`` (outers + 1) + (inners + outers) times (the set-up reads
    nothing); ``cg.step`` once an inner; ``matvec`` and ``precond`` once an
    inner and once a CG start; every child inside its parent, and one solve
    id throughout.  The state, counts and history are the unrecorded
    solve's, bit for bit."""
    u_off, outers_off, inners_off, hist_off = _flagship(driver)
    mark = time.time_ns()
    with profiling.recording():
        assert profiling.is_recording()
        u, outers, inners, hist = _flagship(driver)
    assert torch.equal(u, u_off) and (outers, inners) == (outers_off,
                                                          inners_off)
    if hist is not None:
        assert torch.equal(hist.isnan(), hist_off.isnan())
        assert torch.equal(hist.nan_to_num(), hist_off.nan_to_num())
    recs = _since(mark)
    mine = [r for r in recs if r.name != "gc"]
    count = Counter(r.name for r in mine)
    assert count == {"solve": 1, "setup": 1, "precond.build": 1,
                     "outer": outers, "krylov": outers, "accept": outers,
                     "linearize": outers + 1, "linearize.trace": 1,
                     "read": (outers + 1) + (inners + outers),
                     "cg.step": inners, "matvec": inners + outers,
                     "precond": inners + outers}
    (solve,) = [r for r in mine if r.name == "solve"]
    assert solve.solve == solve.id and solve.parent == 0
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.parent:
            par = by_id[r.parent]
            assert par.start_ns <= r.start_ns <= r.end_ns <= par.end_ns
    assert all(r.solve == solve.id for r in mine)
    parents = {name: {by_id[r.parent].name for r in mine
                      if r.name == name and r.parent} for name in count}
    assert parents["outer"] == {"solve"}
    assert parents["krylov"] == parents["accept"] == {"outer"}
    assert parents["linearize"] == {"outer", "precond.build"}
    assert parents["linearize.trace"] == {"setup"}
    assert parents["cg.step"] == {"krylov"}
    assert parents["matvec"] <= {"krylov", "cg.step"}


def test_solvers_receive_the_objects_themselves_with_spans_off(monkeypatch):
    """With spans off the inner solve gets the Jacobian operator and the
    static apply themselves; with spans on, wrappers that record."""
    seen = []
    solve = solvers.solve

    def spy(algo, A, b, **kw):
        seen.append((A, kw["M"]))
        return solve(algo, A, b, **kw)

    monkeypatch.setattr(newton.solvers, "solve", spy)
    applies = []
    factory = fft_poisson(precision="high")

    def recording_factory(J):
        applies.append(factory(J))
        return applies[-1]

    p = tb.default_config(16, lam=6.0)
    u0 = tb.initial_guess(16, dtype=torch.float64, device="cpu")
    kw = dict(algo="cg", tol_rel=1e-8, krylov_dtype=torch.float32,
              residual_df=tb.residual_scaled_df, M=recording_factory,
              precond_refresh="once")
    nkt.newton_krylov_jit(tb.residual_scaled, u0, p, **kw)
    assert seen and all(type(A) is JacobianOperator and M is applies[0]
                        for A, M in seen)
    seen.clear()
    with profiling.recording():
        nkt.newton_krylov_jit(tb.residual_scaled, u0, p, **kw)
    assert all(type(A) is not JacobianOperator and M is not applies[-1]
               for A, M in seen)


def test_profiler_records_spans_as_named_ranges():
    """Under a CPU profile, without ``recording()``, the spans record and
    each is a ``record_function`` event of its name."""
    mark = time.time_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.is_recording()
        _, outers, _, _ = _flagship("jit", n=16)
    assert not profiling.is_recording()
    recs = _since(mark, {"solve", "outer", "linearize", "cg.step", "read"})
    assert Counter(r.name for r in recs)["outer"] == outers
    events = Counter(e.name for e in prof.events())
    for name, k in Counter(r.name for r in recs).items():
        assert events[name] == k, name


@pytest.mark.parametrize("on", [True, False])
def test_collector_span(on):
    """A collection is a ``gc`` span while spans record, and nothing when
    they do not."""
    mark = time.time_ns()
    if on:
        with profiling.recording(), profiling.span("outer"):
            gc.collect()
    else:
        gc.collect()
    got = _since(mark, {"gc"})
    if not on:
        assert got == []
        return
    (outer,) = _since(mark, {"outer"})
    assert any(r.parent == outer.id and outer.start_ns <= r.start_ns
               <= r.end_ns <= outer.end_ns for r in got)


def test_store_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAPACITY", 3)
    monkeypatch.setattr(profiling, "_STORE", profiling._Store())
    gc.disable()
    try:
        with profiling.recording():
            for name in "abcde":
                with profiling.span(name):
                    pass
    finally:
        gc.enable()
    assert [r.name for r in profiling.spans()] == ["c", "d", "e"]
    d = profiling.dropped()
    assert d.count == 2
    assert 0 < d.newest_end_ns <= profiling.spans()[0].start_ns


def test_export_is_unchanged_by_recording(tmp_path):
    """The exported 16² flagship: the same graph (node targets in order,
    every nested loop body included) with spans on as off, no span of the
    program recorded while exporting, and the loaded call equal to the live
    solve bit for bit."""
    n = 16
    p = tb.default_config(n, lam=5.0)
    u0 = tb.initial_guess(n, dtype=torch.float64, device="cpu")

    def fn(u):
        u, info = nkt.newton_krylov_jit(
            tb.residual_scaled, u, p, algo="cg", tol_rel=1e-8, max_niter=20,
            krylov_dtype=torch.float32, residual_df=tb.residual_scaled_df,
            M=fft_poisson(precision="high"), precond_refresh="once")
        return (u, info.stats.outer_iterations, info.stats.inner_iterations,
                info.solved)

    def targets(ep):
        return [(name, node.op, str(node.target))
                for name, mod in ep.graph_module.named_modules()
                if hasattr(mod, "graph") for node in mod.graph.nodes]

    off = serving.export_solver(fn, (u0,))
    mark = time.time_ns()
    with profiling.recording():
        on = serving.export_solver(fn, (u0,))
    assert _since(mark) == _since(mark, {"gc"})
    assert targets(on) == targets(off)
    live = fn(u0)
    path = serving.save_exported(on, str(tmp_path / "solve.pt2"))
    with profiling.recording():
        mark = time.time_ns()
        loaded = serving.load_exported(path).call(u0)
    assert [r.name for r in _since(mark) if r.name != "gc"] == ["serve"]
    assert torch.equal(loaded[0], live[0])
    assert [int(x) for x in loaded[1:]] == [int(x) for x in live[1:]]

"""``linearize_traces``: the program's ``linearize.trace`` spans inside the
window's solves over the number of solves, on synthetic spans and on a
small solve the program records on the CPU; no result where the program
records no such span (an older checkout)."""
import time
from typing import NamedTuple

import torch

from nkbench import spans, spec


class Rec(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    solve: int


class Run:
    def __init__(self, window_ns):
        self.window_ns, self.lines = window_ns, []

    def log(self, line):
        self.lines.append(line)


def _solve(base, sid, traced=True):
    """A solve whose set-up traces the J·v graph (or, not ``traced``, an
    older program's solve: no such span) and two outers' linearizations."""
    s = sid
    recs = [Rec("solve", base, base + 100, s, 0, s),
            Rec("setup", base + 1, base + 10, s + 1, s, s),
            Rec("outer", base + 10, base + 50, s + 3, s, s),
            Rec("linearize", base + 11, base + 12, s + 4, s + 3, s),
            Rec("outer", base + 50, base + 90, s + 5, s, s),
            Rec("linearize", base + 51, base + 52, s + 6, s + 5, s)]
    if traced:
        recs.append(Rec("linearize.trace", base + 2, base + 8, s + 2, s + 1,
                        s))
    return recs


READER = spec.reader("per_layer", "linearize_traces")


def test_one_trace_a_solve_reads_one():
    w = spans.window_of(_solve(0, 1) + _solve(1000, 11), (0, 2000))
    assert READER.traces(w) == 1.0


def test_a_trace_every_linearization_reads_them_all():
    recs = _solve(0, 1)
    recs += [Rec("linearize.trace", 11, 12, 20, 5, 1),
             Rec("linearize.trace", 51, 52, 21, 7, 1)]
    w = spans.window_of(recs, (0, 2000))
    assert READER.traces(w) == 3.0


def test_no_trace_span_is_no_result():
    w = spans.window_of(_solve(0, 1, traced=False), (0, 2000))
    assert READER.traces(w) is None


def test_recorded_solve_reads_one():
    """A 32² df32 flagship recorded on the CPU traces its J·v once."""
    import newtonkrylov_tpu_torch as nkt
    from newtonkrylov_tpu_torch.fftprec import fft_poisson
    from newtonkrylov_tpu_torch.problems import bratu2d as tb
    from newtonkrylov_tpu_torch.utils import profiling

    p = tb.default_config(32, lam=6.0)
    u0 = tb.initial_guess(32, dtype=torch.float64, device="cpu")
    w0 = time.time_ns()
    with profiling.recording():
        nkt.newton_krylov_jit(
            tb.residual_scaled, u0, p, algo="cg", tol_rel=1e-8,
            krylov_dtype=torch.float32, residual_df=tb.residual_scaled_df,
            M=fft_poisson(precision="high"), precond_refresh="once")
    assert READER.read(Run((w0, time.time_ns()))) == 1.0

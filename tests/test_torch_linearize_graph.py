"""The live solves' J·v graph, traced once a solve, against the per-outer
``torch.func.linearize`` it replaces (``newton._setup``, ``newton._trace_jvp``,
``operator.JacobianOperator`` given ``jvp_graph``).

* The graph's J·v and F(u) equal ``torch.func.linearize``'s bit for bit on
  random tangents, for the Bratu, convection–diffusion, nonlinear-diffusion,
  BVP, 1-D gallery and Kelley residuals.
* Every driver solves on the graph path as it solves with the graph
  withheld (``newton.jvp_graph`` made to raise, so ``_setup`` falls back to
  ``torch.func.linearize`` every linearization): iterate, counts, ``solved``
  and history bit for bit, in every precision mode, with the preconditioner
  built once or every outer.
* A residual that reads a value back to the host cannot be traced with fake
  tensors: it falls back, with the parent path's counts and iterate; a
  residual that closes over a tensor traces.
* ``linearize.trace`` spans count the traces: one a solve, under ``setup``,
  where the graph engages; on the fallback the failed attempt under
  ``setup`` and one under each ``linearize``.
"""

from collections import Counter

import pytest
import torch

import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu_torch import df32, exportable, newton
from newtonkrylov_tpu_torch.examples import continuation_bratu
from newtonkrylov_tpu_torch.fftprec import fft_poisson
from newtonkrylov_tpu_torch.operator import JacobianOperator
from newtonkrylov_tpu_torch.precond import two_grid
from newtonkrylov_tpu_torch.problems import bratu1d as tb1
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.problems import bvp as tbvp
from newtonkrylov_tpu_torch.problems import convdiff2d as tc
from newtonkrylov_tpu_torch.problems import nldiff2d as tn
from newtonkrylov_tpu_torch.problems import simple as ts
from newtonkrylov_tpu_torch.utils import distributed, profiling

F32, F64 = torch.float32, torch.float64


def _refuse(*args, **kwargs):
    raise RuntimeError("J·v graph withheld")


def _withhold(monkeypatch):
    """``_setup`` traces no graph: every linearization runs
    ``torch.func.linearize``, as before the graph path."""
    monkeypatch.setattr(newton, "jvp_graph", _refuse)


def _same_solve(a, b):
    """Two ``(u, NewtonInfo)`` results are equal bit for bit."""
    (ua, ia), (ub, ib) = a, b
    assert torch.equal(ua, ub)
    assert int(ia.stats.outer_iterations) == int(ib.stats.outer_iterations)
    assert int(ia.stats.inner_iterations) == int(ib.stats.inner_iterations)
    assert bool(ia.solved) == bool(ib.solved)
    assert torch.equal(torch.as_tensor(ia.stats.n_res),
                       torch.as_tensor(ib.stats.n_res))
    assert (ia.history is None) == (ib.history is None)
    if ia.history is not None:
        assert torch.equal(ia.history.isnan(), ib.history.isnan())
        assert torch.equal(ia.history.nan_to_num(), ib.history.nan_to_num())


def _traces(fn):
    """``fn()``'s result and its ``linearize.trace`` spans by parent name."""
    with profiling.recording():
        mark = len(profiling.spans())
        out = fn()
        recs = profiling.spans()[mark:]
    by_id = {r.id: r for r in recs}
    return out, Counter(by_id[r.parent].name for r in recs
                        if r.name == "linearize.trace")


# -- J·v: the graph against torch.func.linearize ---------------------------

def _bratu2d(dtype):
    n = 12
    return (tb.residual_scaled, tb.initial_guess(n, dtype=dtype, device="cpu")
            + 0.1, tb.default_config(n, lam=6.0))


RESIDUALS = {
    "bratu2d-f64": lambda: _bratu2d(F64),
    "bratu2d-f32": lambda: _bratu2d(F32),
    "bratu2d-unscaled": lambda: (tb.residual, tb.initial_guess(
        10, dtype=F64, device="cpu"), tb.default_config(10, lam=2.0)),
    "convdiff2d": lambda: (tc.residual_scaled, tc.manufactured_solution(
        12, F64, "cpu") * 0.9, tc.default_config(12, c=25.0, device="cpu")),
    "nldiff2d": lambda: (tn.residual_scaled, tn.manufactured_solution(
        12, dtype=F64, device="cpu") * 0.9, tn.default_config(
            12, device="cpu")),
    "bratu1d": lambda: (tb1.residual, tb1.initial_guess(64, device="cpu"),
                        tb1.default_config(64, 3.51382)),
    "bratu1d-scaled": lambda: (tb1.residual_scaled, tb1.initial_guess(
        64, device="cpu"), tb1.default_config(64, 3.51382)),
    "bvp": lambda: (tbvp.residual, tbvp.initial_guess(tbvp.default_config(
        41, device="cpu")), tbvp.default_config(41, device="cpu")),
    # 0-d operands meet Python scalars: torch.func.jvp would promote the
    # tangent to f64, forward AD (and linearize) keep it f32
    "kelley-f32": lambda: (ts.residual, torch.tensor([2.0, 0.5], dtype=F32),
                           None),
}


@pytest.mark.parametrize("name", sorted(RESIDUALS))
def test_graph_matvec_equals_linearize_bitwise(name):
    F, u, p = RESIDUALS[name]()
    graph = exportable.jvp_graph(F, u, p)
    J_graph = JacobianOperator(F, u, p, jvp_graph=graph)
    J_lin = JacobianOperator(F, u, p)
    gen = torch.Generator().manual_seed(19)
    for _ in range(3):
        v = torch.randn(u.shape, generator=gen, dtype=F64).to(u.dtype)
        assert torch.equal(J_graph.mv(v), J_lin.mv(v))
    assert torch.equal(J_graph.res, J_lin.res)
    assert torch.equal(J_graph.res, F(u, p))
    assert J_graph.shape == J_lin.shape


def test_operator_without_a_graph_linearizes_as_before():
    """No graph: ``torch.func.linearize``, its primal as ``res``, one
    ``linearize.trace`` inside the ``linearize`` span."""
    F, u, p = RESIDUALS["bratu2d-f64"]()
    J, traces = _traces(lambda: JacobianOperator(F, u, p))
    assert traces == {"linearize": 1}
    res, jvp = torch.func.linearize(lambda x: F(x, p), u)
    assert torch.equal(J.res, res)
    assert torch.equal(J.mv(u), jvp(u))


# -- Solves: the graph path against the graph withheld ------------------------

def _bratu_solve(driver, mode, precond, refresh, n=16):
    p = tb.default_config(n, lam=6.0)
    u0 = tb.initial_guess(n, dtype=F64, device="cpu")
    modes = {"df32": dict(krylov_dtype=F32, residual_df=tb.residual_scaled_df),
             "f32-refine": dict(krylov_dtype=F32),
             "f64": {}}
    factory = (fft_poisson(precision="high") if precond == "fft_poisson"
               else two_grid(4, precision="high"))
    drive = {"jit": nkt.newton_krylov_jit, "host": nkt.newton_krylov}[driver]
    return lambda: drive(tb.residual_scaled, u0, p, algo="cg", tol_rel=1e-8,
                         max_niter=20, M=factory, precond_refresh=refresh,
                         **modes[mode])


BRATU_CASES = [(d, m, pc, r) for d in ("jit", "host")
               for m in ("df32", "f32-refine", "f64")
               for pc in ("fft_poisson", "two_grid")
               for r in ("once", "outer")]


def _neg_df(u, q):
    r = tb.residual_scaled_df(u, q)
    return df32.DF(-r.hi, -r.lo)


def _ptc(df):
    """Ψtc on −F (the shifted operator δ⁻¹I + J), GMRES with the DST."""
    n = 32
    p = tb.default_config(n, lam=6.0)
    u0 = tb.initial_guess(n, dtype=F64, device="cpu")
    kw = dict(krylov_dtype=F32, residual_df=_neg_df) if df else {}
    return lambda: nkt.pseudo_transient(
        lambda u, q: -tb.residual_scaled(u, q), u0, p, algo="gmres",
        tol_rel=1e-8, delta0=float((n + 1) ** 2), max_steps=60,
        M=fft_poisson(precision="high"), **kw)


def _continuation_step():
    n = 24
    u1, _ = continuation_bratu.solve_at(
        5.0, tb.initial_guess(n, dtype=F64, device="cpu"), n)
    return lambda: continuation_bratu.solve_at(6.0, u1, n)


OTHER_CASES = {
    "pseudo_transient-f64": lambda: _ptc(False),
    "pseudo_transient-df32": lambda: _ptc(True),
    "continuation-step": _continuation_step,
    "kelley-f32-residual-f64": lambda: (lambda: nkt.newton_krylov_jit(
        ts.residual, torch.tensor([2.0, 0.5], dtype=F32),
        residual_dtype=F64, tol_rel=1e-6)),
    "bratu1d-gmres-host": lambda: (lambda: nkt.newton_krylov(
        tb1.residual, tb1.initial_guess(64, device="cpu"),
        tb1.default_config(64, 2.0), algo="gmres", tol_rel=1e-10)),
    "convdiff2d-gmres-df32": lambda: (lambda: nkt.newton_krylov_jit(
        tc.residual_scaled, tc.initial_guess(16, device="cpu"),
        tc.default_config(16, c=25.0, device="cpu"), algo="gmres",
        krylov_dtype=F32, residual_df=tc.residual_scaled_df, tol_rel=1e-8,
        krylov_kwargs={"restart": 60})),
}


def _check_against_withheld(solve, monkeypatch):
    graph_run, traces = _traces(solve)
    assert traces == {"setup": 1}  # traced once a solve, in the set-up
    monkeypatch.undo()
    _withhold(monkeypatch)
    fallback, traces_off = _traces(solve)
    _same_solve(graph_run, fallback)
    # the withheld path: one linearize.trace a linearization, and none is
    # skipped (the set-up's attempt raised before tracing)
    assert traces_off["linearize"] >= int(fallback[1].stats.outer_iterations)
    assert traces_off["setup"] == 1


@pytest.mark.parametrize("driver,mode,precond,refresh", BRATU_CASES)
def test_bratu_solve_matches_withheld_graph(driver, mode, precond, refresh,
                                            monkeypatch):
    _check_against_withheld(_bratu_solve(driver, mode, precond, refresh),
                            monkeypatch)


@pytest.mark.parametrize("name", sorted(OTHER_CASES))
def test_other_drivers_match_withheld_graph(name, monkeypatch):
    _check_against_withheld(OTHER_CASES[name](), monkeypatch)


def _padded(up, p):
    u = up[1:-1, 1:-1]
    stencil = (up[2:, 1:-1] + up[:-2, 1:-1] + up[1:-1, 2:] + up[1:-1, :-2]
               - 4.0 * u)
    return stencil + (p.dx * p.dx) * p.lam * torch.exp(u)


def _sharded_rank():
    """World 1 (gloo): the sharded df32 Bratu solve, whose residual
    exchanges ghosts through custom ops, on the graph and withheld."""
    from newtonkrylov_tpu_torch import halo

    n = 16
    p = tb.default_config(n, lam=6.0)
    u0 = tb.initial_guess(n, dtype=F64, device="cpu")
    mesh = halo.make_mesh((1, 1), ("i", "j"), device_type="cpu")
    F = halo.sharded_residual_2d(_padded, ("i", "j"), "dirichlet")
    F_df = halo.sharded_residual_df_2d(tb.residual_scaled_df_padded,
                                       ("i", "j"))

    def solve():
        u, info = halo.newton_krylov_sharded(
            F, u0, p, mesh, halo.P("i", "j"), newton_kwargs=dict(
                algo="cg", tol_rel=1e-8, krylov_dtype=F32, residual_df=F_df))
        # numpy, not tensors: a tensor leaves through a file descriptor that
        # dies with the rank
        return [u.numpy(), int(info.stats.outer_iterations),
                int(info.stats.inner_iterations), bool(info.solved),
                info.history.nan_to_num().numpy()]

    graph_run = solve()
    jvp_graph, newton.jvp_graph = newton.jvp_graph, _refuse
    try:
        fallback = solve()
    finally:
        newton.jvp_graph = jvp_graph
    return {"graph": graph_run, "fallback": fallback}


def test_sharded_world1_solve_matches_withheld_graph():
    (out,) = distributed.run_processes(_sharded_rank, 1, timeout=240.0)
    g, f = out["graph"], out["fallback"]
    assert g[1:4] == f[1:4] and g[3]
    assert g[0].dtype == f[0].dtype and g[0].tobytes() == f[0].tobytes()
    assert g[4].tobytes() == f[4].tobytes()


# -- Fallback -----------------------------------------------------------------

def _host_read_residual(u, p):
    """The Bratu residual with λ read back to the host from a tensor."""
    return tb.residual_scaled(u, p._replace(lam=float(p.lam)))


def test_host_read_residual_falls_back_with_the_parent_counts(monkeypatch):
    n = 16
    p = tb.default_config(n, lam=6.0)
    p = p._replace(lam=torch.tensor(6.0, dtype=F64))
    u0 = tb.initial_guess(n, dtype=F64, device="cpu")

    def solve():
        return nkt.newton_krylov_jit(
            _host_read_residual, u0, p, algo="cg", tol_rel=1e-8,
            krylov_dtype=F32, residual_df=lambda u, q: tb.residual_scaled_df(
                u, q._replace(lam=float(q.lam))),
            M=fft_poisson(precision="high"), precond_refresh="once")

    assert newton._trace_jvp(_host_read_residual, (u0.float(), p)) is None
    got, traces = _traces(solve)
    outers = int(got[1].stats.outer_iterations)
    # the set-up's failed attempt, then one trace nested in each of the
    # outers + 1 linearizations (the static preconditioner's J₀ included)
    assert traces == {"setup": 1, "linearize": outers + 1}
    # the Bratu residual itself, λ a number, traces once
    _, traces = _traces(lambda: nkt.newton_krylov_jit(
        tb.residual_scaled, u0, tb.default_config(n, lam=6.0), algo="cg",
        tol_rel=1e-8, krylov_dtype=F32, residual_df=tb.residual_scaled_df))
    assert traces == {"setup": 1}
    _withhold(monkeypatch)
    _same_solve(got, solve())


def test_closed_over_tensor_traces():
    """A residual closing over a tensor traces: the tensor is a constant of
    the graph, and J·v equals linearize's."""
    gen = torch.Generator().manual_seed(3)
    c = torch.rand(40, generator=gen, dtype=F64)

    def F(u, p):
        return torch.exp(u) * c - 1.0

    u = torch.zeros(40, dtype=F64)
    graph = newton._trace_jvp(F, (u, None))
    assert graph is not None
    v = torch.randn(40, generator=gen, dtype=F64)
    assert torch.equal(graph(u + 0.5, v, None),
                       JacobianOperator(F, u + 0.5).mv(v))

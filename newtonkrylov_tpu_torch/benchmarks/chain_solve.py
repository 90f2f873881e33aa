"""The chained-solve protocol of the JAX package's bench lanes, on the port.

Counterpart of ``make_chain_solve`` and ``chain_wall`` (``bench.py:63-101``)
and of the differencing at ``bench.py:257-262``.  A lane is the flagship
configuration — 2-D Bratu at λ, CG with an f32 Krylov loop, the df32
acceptance residual (``residual_scaled_df``), ``tol_rel=1e-8``,
``max_niter=20`` — with a preconditioner factory ``M`` refreshed every
outer (``refresh="outer"``) or built once at u₀ (``"once"``).

``make_chain_solve(...)(u0, k)`` runs k solves, the i-th from
``u0·(1 + 1e-6·(i+1))`` (f64 arithmetic on the state's device), and ends in
a synchronization.  Where the JAX package compiles the k solves into one
program, the port issues them from Python, one after another; no layer
could reuse a result, so the perturbation only keeps the inputs of the two
protocols equal.  The marginal wall of a solve is the difference between
k_hi chained solves and one, over k_hi − 1 (:func:`marginal`); every timed
lane is backed by a verified solve, the chain's last.

Imported by the port's XL lanes (:mod:`.xl8192`), by ``chip_smoke.py``'s
path (u) and, later, by the port's benchmark lane.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple, Optional

import torch

from ..utils.profiling import _synchronize

LAM = 5.0


class Chain(NamedTuple):
    """What k chained solves leave: a checksum (Σ over the solves of
    Σu + inner iterations, a 0-d f64 tensor), the last solve's state, the
    state it started from and its ``NewtonInfo``."""
    acc: torch.Tensor
    u: Any
    u_start: Any
    info: Any


def flagship_kwargs(M=None, refresh="outer"):
    """The keyword arguments of ``newton_krylov_jit`` for a lane: the
    flagship configuration with factory ``M`` refreshed per ``refresh``."""
    from ..problems import bratu2d

    return dict(algo="cg", tol_rel=1e-8, krylov_dtype=torch.float32,
                residual_df=bratu2d.residual_scaled_df, max_niter=20,
                M=M, precond_refresh=refresh)


def make_chain_solve(ns: int, M=None, refresh: str = "outer",
                     lam: float = LAM):
    """``f(u0, k) -> Chain``: k flagship-configuration solves at ns², the
    i-th from ``u0·(1 + 1e-6·(i+1))``, synchronized at the end."""
    from ..newton import newton_krylov_jit
    from ..problems import bratu2d

    p = bratu2d.default_config(ns, lam=lam)
    kwargs = flagship_kwargs(M, refresh)

    def f(u0, k: int) -> Chain:
        if k < 1:
            raise ValueError("a chain runs at least one solve")
        acc = torch.zeros((), dtype=torch.float64, device=u0.device)
        for i in range(k):
            u_start = u0 * (1.0 + 1e-6 * (i + 1))
            u, info = newton_krylov_jit(bratu2d.residual_scaled, u_start, p,
                                        **kwargs)
            acc = acc + u.sum() + info.stats.inner_iterations
        _synchronize(acc)
        return Chain(acc, u, u_start, info)

    return f


def chain_wall(f, u0, k: int, r: int):
    """(host seconds of ``f(u, k)``, its Chain), u = u0·(1 + 1e-7·(r+1)),
    made and synchronized before the clock starts."""
    u = u0 * (1.0 + 1e-7 * (r + 1))
    _synchronize(u)
    t0 = time.perf_counter()
    out = f(u, k)
    return time.perf_counter() - t0, out


class Marginal(NamedTuple):
    """A lane's timing: the marginal seconds per solve, the best walls of
    one and of k_hi chained solves, k_hi, and the Chain of the one-solve
    run that backs it."""
    s: float
    t1: float
    t_hi: float
    k_hi: int
    chain: Chain


def marginal(f, u0, k_hi: int = 3, repeats: int = 2, warm: bool = True,
             ) -> Marginal:
    """The JAX lanes' differencing: after a warm call of each length
    (``warm``), the best of ``repeats`` walls of 1 and of ``k_hi`` chained
    solves; the marginal is ``max(t_hi − t1, 0) / (k_hi − 1)``."""
    if k_hi < 2:
        raise ValueError("the marginal wall needs k_hi >= 2")
    if warm:
        f(u0, 1)
        f(u0, k_hi)
    ones = [chain_wall(f, u0, 1, r) for r in range(repeats)]
    his = [chain_wall(f, u0, k_hi, r + repeats) for r in range(repeats)]
    t1 = min(t for t, _ in ones)
    t_hi = min(t for t, _ in his)
    return Marginal(max(t_hi - t1, 0.0) / (k_hi - 1), t1, t_hi, k_hi,
                    ones[-1][1])


def true_residual(u, u_start, lam: float = LAM):
    """(‖F(u)‖, ‖F(u_start)‖) of the plain scaled residual in f64."""
    from ..problems import bratu2d

    p = bratu2d.default_config(u.shape[-1], lam=lam)

    def norm(x):
        return float(torch.linalg.vector_norm(
            bratu2d.residual_scaled(x.to(torch.float64), p)))

    return norm(u), norm(u_start)


def clamped_tol(u_start, tol_rel: float = 1e-8, tol_abs: float = 1e-12,
                floor_rtol: float = 2.0, lam: float = LAM):
    """(the tolerance the df32 drivers accept at, the unclamped one,
    ``floor_rtol``·floor at u₀): ``max(tol_rel·‖F₀‖ + tol_abs,
    floor_rtol·floor_estimate(u₀))`` as ``newton._setup`` computes it, ‖F₀‖
    the f32 norm of the df32 residual's hi word."""
    from .. import df32 as dd
    from ..problems import bratu2d
    from ..tree import tree_norm

    p = bratu2d.default_config(u_start.shape[-1], lam=lam)
    n0 = float(tree_norm(
        bratu2d.residual_scaled_df(dd.df_from_f64(u_start), p).hi))
    tol = tol_rel * n0 + tol_abs
    floor = floor_rtol * float(dd.floor_estimate(
        bratu2d.residual_scaled, dd.df_from_f64(u_start).hi, p))
    return max(tol, floor), tol, floor


class Busy(NamedTuple):
    """One call under the profiler: its result, the device-busy seconds,
    the profiled host seconds and the number of device events."""
    out: Any
    busy_s: float
    wall_s: float
    events: int


def device_busy(fn) -> Busy:
    """``fn()`` once under ``torch.profiler``: the durations of the events
    that ran on the card, summed (one stream: they do not overlap).  The
    profiler's raw events are read directly; turning them into
    ``FunctionEvent``s costs ~100 µs an event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = [e.end_ns() - e.start_ns()
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    return Busy(out, sum(spans) / 1e9, wall, len(spans))


def describe(tag: str, ns: int, m: Optional[Marginal], chain: Chain) -> str:
    """One line for a lane, in the JAX lanes' words."""
    info = chain.info
    wall = "" if m is None else (
        f"marginal {m.s * 1e3:.1f} ms/solve (1 solve {m.t1:.3f} s, "
        f"{m.k_hi} chained {m.t_hi:.3f} s), ")
    return (f"JFNK df32-refined {ns}x{ns} to 1e-8 [{tag}]: {wall}"
            f"solved={bool(info.solved)} "
            f"outer={int(info.stats.outer_iterations)} "
            f"inner={int(info.stats.inner_iterations)}"
            + (" floor_limited" if bool(info.floor_limited) else ""))

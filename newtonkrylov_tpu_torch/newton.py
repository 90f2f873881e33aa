"""Inexact Newton–Krylov driver.

Counterpart of :func:`newtonkrylov_tpu.newton.newton_krylov_jit`, with the
reference's semantics and defaults:

* ``tol = tol_rel·‖F(u₀)‖ + tol_abs`` (``tol_rel = 1e-6``,
  ``tol_abs = 1e-12``); loop while ``‖F‖ > tol`` and ``outer ≤ max_niter``.
* Per outer iteration: preconditioner factories ``M(J)``/``N(J)`` (or once at
  u₀), inner ``rtol = η`` from the forcing strategy, solve ``J d = F(u)``,
  step ``u ← u − d``; abort when ‖F‖ goes NaN/Inf.

The JAX package runs this loop as one XLA ``while_loop``.  Here it is a
Python loop over device tensors: the state, residual, η, tolerance and
history stay on the device, and each outer iteration reads one boolean
back, in its loop condition (the CG loop inside reads one per inner
iteration).  Capturing the loop in CUDA graphs is later work.

The host-stepped ``newton_krylov`` driver is not ported yet (ROADMAP.md
Queue 1, item 7).
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional

import torch

from . import df32 as _dd
from . import solvers
from .forcing import EisenstatWalker, Forcing
from .operator import JacobianOperator
from .spaces import EuclideanSpace, VectorSpace
from .tree import tree_dtype, tree_leaves, tree_map, tree_sub

__all__ = ["Stats", "NewtonInfo", "newton_krylov_jit"]


class Stats(NamedTuple):
    """Solve statistics."""

    outer_iterations: Any
    inner_iterations: Any
    n_res: Any


class NewtonInfo(NamedTuple):
    """Second return value of the driver."""

    solved: Any
    stats: Stats
    t: Any
    history: Any = None  # residual-norm trace, NaN-padded to max_niter + 2
    floor_limited: Any = False  # df32 path: tol was clamped to the measured
    #   representation floor (floor_rtol)


def _cast_floating(tree, dt):
    """Cast floating tensors of the params ``p`` to ``dt`` (ints, bools and
    Python scalars untouched), so f64 params cannot promote a
    low-precision inner loop back to f64."""
    def cast(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            return leaf.to(dt)
        return leaf

    if tree is None:
        return None
    return tree_map(cast, tree)


def _linearize_for_inner(F, p, u, res, krylov_dtype, residual_df):
    """(J, b) for the inner solve under the three precision modes:

    * df32 — linearize at the hi word, RHS = carried ``res.hi``, both in
      ``krylov_dtype``, params' float tensors cast down too;
    * low-precision refinement — state and carried residual cast down;
    * plain — linearize at the state.
    """
    if residual_df is not None:
        u_low = u.hi.to(krylov_dtype)
        J = JacobianOperator(F, u_low, _cast_floating(p, krylov_dtype))
        b = res.hi.to(krylov_dtype)
    elif krylov_dtype is not None:
        u_low = tree_map(lambda l: l.to(krylov_dtype), u)
        J = JacobianOperator(F, u_low, _cast_floating(p, krylov_dtype))
        b = tree_map(lambda l: l.to(krylov_dtype), res)
    else:
        J = JacobianOperator(F, u, p)
        # the linearization's own primal, not the carried residual: the
        # JAX package pins this choice for count parity between its drivers
        b = J.res
    return J, b


def _resolve_forcing(forcing):
    if forcing is None or isinstance(forcing, Forcing):
        return forcing
    raise TypeError(f"forcing must be a Forcing or None, got {forcing!r}")


def newton_krylov_jit(
    F: Callable,
    u0: Any,
    p: Any = None,
    *,
    tol_rel: float = 1.0e-6,
    tol_abs: float = 1.0e-12,
    max_niter: int = 50,
    forcing: Optional[Forcing] = EisenstatWalker(),
    algo: str = "gmres",
    M: Optional[Callable] = None,
    N: Optional[Callable] = None,
    krylov_kwargs: Optional[dict] = None,
    linesearch: Optional[str] = None,
    space: Optional[VectorSpace] = None,
    residual_dtype=None,
    krylov_dtype=None,
    residual_df: Optional[Callable] = None,
    precond_refresh: str = "outer",
    floor_rtol: Optional[float] = 2.0,
):
    """Solve F(u, p) = 0 by inexact Newton–Krylov.

    Returns ``(u, NewtonInfo)``: ``solved`` and ``stats.n_res`` are device
    tensors, the iteration counts Python ints, ``t`` the wall-clock seconds
    of the solve and ``history`` a ``(max_niter + 2,)`` residual-norm trace
    padded with NaN.

    Precision modes:

    * ``krylov_dtype``: iterative refinement — the state and the outer
      residual stay in the state dtype, the linearization and the Krylov
      loop run in ``krylov_dtype``.
    * ``residual_df``: a df32 evaluation of the same residual,
      ``residual_df(DF(u), p) -> DF``.  The state is carried as a df32 pair,
      the inner loop (``krylov_dtype``, default f32) takes ``hi`` as its
      RHS.  An f64 ``u0`` is split at the boundary and the result returned
      as f64 (hi + lo); otherwise the hi word is returned.
      ``floor_rtol`` clamps the tolerance to ``floor_rtol`` times the
      measured df32 representation floor
      (:func:`~newtonkrylov_tpu_torch.df32.floor_estimate`);
      ``info.floor_limited`` reports whether the clamp engaged.

    ``precond_refresh``: ``"outer"`` re-invokes the ``M``/``N`` factories
    every outer iteration; ``"once"`` invokes them on the u₀ operator.

    ``linesearch`` and ``residual_dtype`` are not ported yet (ROADMAP.md
    Queue 1, item 7).
    """
    space = space or EuclideanSpace()
    forcing = _resolve_forcing(forcing)
    krylov_kwargs = dict(krylov_kwargs or {})
    if precond_refresh not in ("outer", "once"):
        raise ValueError(f"unknown precond_refresh {precond_refresh!r}")
    if linesearch is not None or residual_dtype is not None:
        raise NotImplementedError(
            "linesearch and residual_dtype are not ported yet "
            "(ROADMAP.md Queue 1, item 7)")

    t0 = time.perf_counter()
    if residual_df is not None:
        if krylov_dtype is None:
            krylov_dtype = torch.float32
        out_f64 = any(l.dtype == torch.float64 for l in tree_leaves(u0))
        u0 = _dd.df_from_f64(u0)
        res0 = residual_df(u0, p)
        n_res0 = space.norm(res0.hi)
    else:
        res0 = F(u0, p)
        n_res0 = space.norm(res0)
    dtype, device = n_res0.dtype, n_res0.device
    tol = tol_rel * n_res0 + tol_abs
    floor_limited = torch.zeros((), dtype=torch.bool, device=device)
    if residual_df is not None and floor_rtol is not None:
        floor0 = _dd.floor_estimate(
            F, u0.hi.to(krylov_dtype), _cast_floating(p, krylov_dtype),
            space=space)
        tol_clamped = torch.maximum(tol, floor_rtol * floor0)
        floor_limited = tol_clamped > tol
        tol = tol_clamped
    eta = torch.full((), forcing.initial() if forcing is not None else 0.0,
                     dtype=dtype, device=device)
    hist = torch.full((max_niter + 2,), float("nan"), dtype=dtype,
                      device=device)
    hist[0] = n_res0

    m_static = n_static = None
    if precond_refresh == "once" and (M is not None or N is not None):
        if residual_df is not None:
            J0 = JacobianOperator(F, u0.hi.to(krylov_dtype),
                                  _cast_floating(p, krylov_dtype))
        elif krylov_dtype is not None:
            J0 = JacobianOperator(F, tree_map(lambda l: l.to(krylov_dtype), u0),
                                  _cast_floating(p, krylov_dtype))
        else:
            J0 = JacobianOperator(F, u0, p)
        m_static = M(J0) if M is not None else None
        n_static = N(J0) if N is not None else None

    u, res, n_res = u0, res0, n_res0
    outer = inner = 0
    blown = torch.zeros((), dtype=torch.bool, device=device)
    while outer <= max_niter and bool((n_res > tol) & ~blown):
        # The high-precision residual is carried from the previous outer's
        # acceptance evaluation: one high-precision residual per outer.
        J, b = _linearize_for_inner(F, p, u, res, krylov_dtype, residual_df)
        kw = dict(krylov_kwargs)
        kw["space"] = space
        kw.setdefault("atol", 0.0)  # the outer loop owns the absolute tolerance
        if N is not None:
            kw["N"] = n_static if n_static is not None else N(J)
        if M is not None:
            kw["M"] = m_static if m_static is not None else M(J)
        if forcing is not None:
            kw["rtol"] = eta.to(tree_dtype(b))
        result = solvers.solve(algo, J, b, **kw)
        if residual_df is not None:
            u_new = _dd.tree_add_f32(u, -result.x.to(torch.float32))
            res_new = residual_df(u_new, p)
            n_new = space.norm(res_new.hi)
        else:
            d = result.x
            if krylov_dtype is not None:
                state_dt = tree_dtype(u)
                d = tree_map(lambda l: l.to(state_dt), d)
            u_new = tree_sub(u, d)
            res_new = F(u_new, p)
            n_new = space.norm(res_new)
        blown = ~torch.isfinite(n_new)
        if forcing is not None:
            eta = forcing(eta, tol, n_new, n_res)
        hist[outer + 1] = n_new
        u, res, n_res = u_new, res_new, n_new
        outer += 1
        inner += result.niter

    info = NewtonInfo(
        solved=(n_res <= tol) & ~blown,
        stats=Stats(outer, inner, n_res),
        t=time.perf_counter() - t0,
        history=hist,
        floor_limited=floor_limited,
    )
    if residual_df is not None:
        return (_dd.df_to_f64(u) if out_f64 else u.hi), info
    return u, info

"""Inexact Newton–Krylov drivers.

Counterpart of ``newtonkrylov_tpu/newton.py``, with the reference's
semantics and defaults:

* ``tol = tol_rel·‖F(u₀)‖ + tol_abs`` (``tol_rel = 1e-6``,
  ``tol_abs = 1e-12``); loop while ``‖F‖ > tol`` and ``outer ≤ max_niter``.
* Per outer iteration: preconditioner factories ``M(J)``/``N(J)`` (or once at
  u₀), inner ``rtol = η`` from the forcing strategy, solve ``J d = F(u)``,
  step ``u ← u − d`` (or an Armijo backtracking step); abort when ‖F‖ goes
  NaN/Inf.
* ``algo="gmres"`` (the default) or ``"fgmres"`` without a ``restart`` in
  ``krylov_kwargs`` runs one cycle of basis ``min(n, 100)``.

Two drivers share one Newton step (:func:`_newton_step`):

:func:`newton_krylov`
    The reference's interactive driver: ``callback(u, res, n_res)`` after
    every residual evaluation, leveled ``verbose`` output, host-side
    preconditioner factories (:func:`~newtonkrylov_tpu_torch.precond.ilu0`,
    :func:`~newtonkrylov_tpu_torch.precond.banded_lu`), and the forcing
    updated on the host (``Forcing.host_update``).  It reads ‖F‖ back once
    per outer iteration.
:func:`newton_krylov_jit`
    The JAX package runs this one as one XLA ``while_loop``.  Here it is a
    Python loop over device tensors: the state, residual, η, tolerance and
    history stay on the device, and each outer iteration reads one boolean
    back, in its loop condition.  It returns a residual-norm history.

The two give the same iterates, bit for bit, and the same counts: the
step is one function, and where the outer norm is float64 the host's
forcing update is the device's arithmetic.  Under ``torch.export`` the loop
of :func:`newton_krylov_jit` is a ``while_loop`` over the same body, so a
whole solve exports as one program (:mod:`~newtonkrylov_tpu_torch.exportable`,
:mod:`~newtonkrylov_tpu_torch.utils.serving`); :func:`newton_krylov` has
no exported form.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, NamedTuple, Optional

import torch

from . import df32 as _dd
from . import solvers
from .exportable import (counter, exporting, jvp_graph, record,
                         require_eager, vjp_graph, while_loop)
from .forcing import EisenstatWalker, Forcing
from .operator import JacobianOperator, LinearOperator, ShiftedOperator
from .spaces import EuclideanSpace, VectorSpace
from .tree import (tree_axpy, tree_dtype, tree_leaves, tree_map, tree_size,
                   tree_sub, tree_where)
from .utils.profiling import is_recording, span, spanned

__all__ = ["Stats", "NewtonInfo", "NewtonOptions", "newton_krylov",
           "newton_krylov_jit"]


class Stats(NamedTuple):
    """Solve statistics."""

    outer_iterations: Any
    inner_iterations: Any
    n_res: Any


class NewtonInfo(NamedTuple):
    """Second return value of the drivers."""

    solved: Any
    stats: Stats
    t: Any
    history: Any = None  # residual-norm trace, NaN-padded to max_niter + 2
    floor_limited: Any = False  # df32 path: tol was clamped to the measured
    #   representation floor (floor_rtol)


class NewtonOptions(NamedTuple):
    """Static configuration of the drivers."""

    tol_rel: float = 1.0e-6
    tol_abs: float = 1.0e-12
    max_niter: int = 50
    algo: str = "gmres"
    linesearch: Optional[str] = None


# The reference's inner GMRES (Krylov.jl) is non-restarted; the drivers
# default to one full cycle of basis min(n, 100), which gives the
# non-restarted counts whenever the inner solve converges within the basis
# and restarts beyond it.  ``krylov_kwargs={"restart": ...}`` overrides.
_PARITY_GMRES_BASIS = 100


def _gmres_parity_default(krylov_kwargs: dict, algo: str, example_res) -> None:
    if algo in ("gmres", "fgmres") and "restart" not in krylov_kwargs:
        krylov_kwargs["restart"] = min(tree_size(example_res), _PARITY_GMRES_BASIS)


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


def _linearization_point(p, u, krylov_dtype, residual_df):
    """(u, p) at which the inner operator is linearized under the three
    precision modes (see :func:`_linearize_for_inner`)."""
    if residual_df is not None:
        return (tree_map(lambda l: l.to(krylov_dtype), u.hi),
                _cast_floating(p, krylov_dtype))
    if krylov_dtype is not None:
        return (tree_map(lambda l: l.to(krylov_dtype), u),
                _cast_floating(p, krylov_dtype))
    return u, p


def _linearize_for_inner(F, p, u, res, krylov_dtype, residual_df,
                         jvp_graph=None, vjp_graph=None):
    """(J, b) for the inner solve under the three precision modes:

    * df32 — linearize at the hi word, RHS = carried ``res.hi``, both in
      ``krylov_dtype``, params' float tensors cast down too;
    * low-precision refinement — state and carried residual cast down;
    * plain — linearize at the state.

    ``jvp_graph`` is the J·v graph the solve traced in :func:`_setup`
    (None: ``torch.func.linearize`` every call); ``vjp_graph`` the Jᵀ·w
    graph an export traced ahead of its loops.
    """
    u_lin, p_lin = _linearization_point(p, u, krylov_dtype, residual_df)
    J = JacobianOperator(F, u_lin, p_lin, jvp_graph=jvp_graph,
                         vjp_graph=vjp_graph)
    if residual_df is not None:
        b = tree_map(lambda l: l.to(krylov_dtype), res.hi)
    elif krylov_dtype is not None:
        b = tree_map(lambda l: l.to(krylov_dtype), res)
    else:
        # the linearization's own primal, not the carried residual: the
        # JAX package pins this choice for count parity between its drivers
        b = J.res
    return J, b


def _resolve_forcing(forcing):
    if forcing is None or isinstance(forcing, Forcing):
        return forcing
    raise TypeError(f"forcing must be a Forcing or None, got {forcing!r}")


def _armijo_step(F, p, space, u, d, n_res, sigma=1.0e-4, max_backtracks=8):
    """Backtracking line search on ‖F‖: the first s of 1, ½, ¼, … (at most
    ``max_backtracks`` trials) with ‖F(u − s·d)‖ ≤ (1 − σs)·‖F(u)‖.  Every
    trial is evaluated and the accepted one selected with ``torch.where``
    (no host read); when none is accepted, the s = 1 trial is kept, the
    reference's full step.  Returns (u, F(u), ‖F(u)‖) of the step taken."""
    s = torch.ones((), dtype=n_res.dtype, device=n_res.device)
    accepted = torch.zeros((), dtype=torch.bool, device=n_res.device)
    u_new = res_new = n_new = None
    for _ in range(max_backtracks):
        u_try = tree_axpy(-s, d, u)
        res_try = F(u_try, p)
        n_try = space.norm(res_try)
        ok = (n_try <= (1.0 - sigma * s) * n_res) & ~accepted
        if u_new is None:
            u_new, res_new, n_new = u_try, res_try, n_try
        else:
            u_new = tree_where(ok, u_try, u_new)
            res_new = tree_where(ok, res_try, res_new)
            n_new = torch.where(ok, n_try, n_new)
        accepted = accepted | ok
        s = s * 0.5
    return u_new, res_new, n_new


class _Setup(NamedTuple):
    """What a driver carries into its loop (see :func:`_setup`)."""

    u0: Any            # the state as the loop carries it (a DF pair for df32)
    res0: Any          # its acceptance residual
    n_res0: torch.Tensor
    tol: torch.Tensor  # 0-d, in the dtype of the outer norm
    floor_limited: torch.Tensor
    krylov_dtype: Any
    out_f64: bool      # df32 path: return hi + lo as float64
    outer_res: Callable  # u ↦ its acceptance residual
    jvp_graph: Optional[Callable] = None  # J·v, traced once a solve (None:
    #   the residual does not trace with fake tensors)
    vjp_graph: Optional[Callable] = None  # exporting, CGLS: Jᵀ·w, traced once


def _trace_jvp(F, point):
    """The J·v graph of ``F`` at states and parameters shaped like
    ``point`` (:func:`~newtonkrylov_tpu_torch.exportable.jvp_graph`), or,
    eagerly, None where ``F`` cannot be traced with fake tensors (a
    residual that reads a value back to the host): every linearization of
    the solve then runs ``torch.func.linearize``."""
    if exporting():
        return jvp_graph(F, *point)
    with span("linearize.trace"):
        try:
            return jvp_graph(F, *point)
        except Exception:  # any trace failure falls back to linearize
            return None


@spanned("setup")
def _setup(F, u0, p, *, space, algo, krylov_kwargs, tol_rel, tol_abs,
           krylov_dtype, residual_df, residual_dtype=None, linesearch=None,
           floor_rtol=None) -> _Setup:
    """The precision mode, the initial residual and the tolerance.

    The acceptance residual is ``residual_df(DF(u), p)`` on the df32 path,
    ``F(u in residual_dtype, p)`` with ``residual_dtype`` and ``F(u, p)``
    otherwise; ``krylov_kwargs`` gains the GMRES parity basis.  On the df32
    path ``floor_rtol`` clamps the tolerance to that multiple of the
    measured representation floor (:func:`~newtonkrylov_tpu_torch.df32.floor_estimate`).
    The residual's J·v is traced here, once a solve (:func:`_trace_jvp`).
    """
    if linesearch not in (None, "armijo"):
        raise ValueError(f"unknown linesearch {linesearch!r}; use None or \"armijo\"")
    out_f64 = False
    if residual_df is not None:
        if residual_dtype is not None or linesearch is not None:
            raise ValueError("residual_df excludes residual_dtype and linesearch")
        if krylov_dtype is None:
            krylov_dtype = torch.float32
        out_f64 = any(l.dtype == torch.float64 for l in tree_leaves(u0))
        u0 = _dd.df_from_f64(u0)

        def outer_res(u):
            return residual_df(u, p)
    elif residual_dtype is not None:
        def outer_res(u):
            return F(tree_map(lambda l: l.to(residual_dtype), u), p)
    else:
        def outer_res(u):
            return F(u, p)

    res0 = outer_res(u0)
    res0_main = res0.hi if residual_df is not None else res0
    _gmres_parity_default(krylov_kwargs, algo, res0_main)
    n_res0 = space.norm(res0_main)
    tol = tol_rel * n_res0 + tol_abs
    # the linearization is traced once, ahead of the loops (and, by an
    # export, the transpose, for CGLS)
    point = _linearization_point(p, u0, krylov_dtype, residual_df)
    graph = _trace_jvp(F, point)
    vgraph = vjp_graph(F, *point) if exporting() and algo == "cgls" else None
    floor_limited = torch.zeros((), dtype=torch.bool, device=n_res0.device)
    if residual_df is not None and floor_rtol is not None:
        floor0 = _dd.floor_estimate(
            F, tree_map(lambda l: l.to(krylov_dtype), u0.hi),
            _cast_floating(p, krylov_dtype), space=space, jvp_graph=graph)
        tol_clamped = torch.maximum(tol, floor_rtol * floor0)
        floor_limited = tol_clamped > tol
        tol = tol_clamped
    return _Setup(u0, res0, n_res0, tol, floor_limited, krylov_dtype, out_f64,
                  outer_res, graph, vgraph)


@spanned("precond.build")
def _static_preconditioners(F, p, s: _Setup, M, N, residual_df):
    """``(M(J₀), N(J₀))`` on the u₀ operator of the precision mode, for
    ``precond_refresh="once"``."""
    J0, _ = _linearize_for_inner(F, p, s.u0, s.res0, s.krylov_dtype,
                                 residual_df, s.jvp_graph, s.vjp_graph)
    return (M(J0) if M is not None else None), (N(J0) if N is not None else None)


class _SpannedOperator(LinearOperator):
    """The inner solve's operator with each J·v a ``matvec`` span; every
    other attribute is the wrapped operator's."""

    def __init__(self, A):
        self.A = A

    def mv(self, v):
        with span("matvec"):
            return self.A.mv(v)

    def __getattr__(self, attr):
        return getattr(self.A, attr)


@spanned("precond.build")
def _build(factory, A):
    """A preconditioner factory's call on the outer's operator."""
    return factory(A)


def _spanned_apply(apply):
    """A preconditioner apply with each call a ``precond`` span."""
    def call(v):
        with span("precond"):
            return apply(v)
    return call


def _newton_step(F, p, s: _Setup, u, res, n_res, rtol, *, space, algo,
                 krylov_kwargs, M, N, m_static=None, n_static=None,
                 residual_df=None, residual_dtype=None, linesearch=None,
                 shift=None):
    """One outer iteration of every driver: linearize, solve, update.

    The inner operator is J, or ``shift``·I + J (pseudo-transient
    continuation); the factories ``M``/``N`` are invoked on it unless a
    static apply is given.  ``rtol`` is η (a float or a 0-d tensor), or
    None for the solver's default.  Returns (u, its acceptance residual,
    the residual's norm, inner iterations).
    """
    J, b = _linearize_for_inner(F, p, u, res, s.krylov_dtype, residual_df,
                                s.jvp_graph, s.vjp_graph)
    A = J if shift is None else ShiftedOperator(J, shift)
    kw = dict(krylov_kwargs)
    kw["space"] = space
    # The outer loop owns the absolute tolerance: a nonzero inner atol
    # (Krylov.jl's √eps default) ends the inner solve at 0 iterations once
    # ‖F‖ is small, a stall in f32.
    kw.setdefault("atol", 0.0)
    if N is not None:
        kw["N"] = n_static if n_static is not None else _build(N, A)
    if M is not None:
        kw["M"] = m_static if m_static is not None else _build(M, A)
    if rtol is not None:
        b_leaf = tree_leaves(b)[0]
        kw["rtol"] = torch.as_tensor(rtol, dtype=tree_dtype(b),
                                     device=b_leaf.device)
    if is_recording():
        # each J·v and preconditioner apply a span; with spans off the
        # solver gets the operator and the applies themselves
        A = _SpannedOperator(A)
        for k in ("M", "N"):
            if k in kw:
                kw[k] = _spanned_apply(kw[k])
    with span("krylov"):
        result = solvers.solve(algo, A, b, **kw)
    if residual_df is not None:
        u_new = _dd.tree_add_f32(u, tree_map(lambda l: -l.to(torch.float32),
                                             result.x))
        with span("accept"):
            res_new = residual_df(u_new, p)
            n_new = space.norm(res_new.hi)
        return u_new, res_new, n_new, result.niter
    d = result.x
    if s.krylov_dtype is not None:
        state_dt = tree_dtype(u)
        d = tree_map(lambda l: l.to(state_dt), d)
    with span("accept"):
        if linesearch == "armijo":
            u_new, res_new, n_new = _armijo_step(F, p, space, u, d, n_res)
            if residual_dtype is not None:
                res_new = s.outer_res(u_new)
                n_new = space.norm(res_new)
        else:
            u_new = tree_sub(u, d)
            res_new = s.outer_res(u_new)
            n_new = space.norm(res_new)
    return u_new, res_new, n_new, result.niter


def _finish(s: _Setup, u):
    """The returned state: df32 pairs leave as f64 (hi + lo) or the hi word."""
    if isinstance(u, _dd.DF):
        return _dd.df_to_f64(u) if s.out_f64 else u.hi
    return u


@spanned("solve")
def newton_krylov(
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
    callback: Optional[Callable] = None,
    verbose: int = 0,
    linesearch: Optional[str] = None,
    space: Optional[VectorSpace] = None,
    jit_step: bool = True,
    residual_dtype=None,
    krylov_dtype=None,
    precond_refresh: str = "outer",
    residual_df: Optional[Callable] = None,
    floor_rtol: Optional[float] = 2.0,
):
    """Solve F(u, p) = 0 by inexact Newton–Krylov, stepped from the host
    (the reference's ``newton_krylov``).

    ``F`` is the pure residual ``res = F(u, p)``; ``M``/``N`` are left/right
    preconditioner *factories*, called with the current
    :class:`~newtonkrylov_tpu_torch.operator.JacobianOperator` every outer
    iteration (``precond_refresh="outer"``) or once on the u₀ operator
    (``"once"``).  A factory marked ``host_side = True``
    (:func:`~newtonkrylov_tpu_torch.precond.ilu0`,
    :func:`~newtonkrylov_tpu_torch.precond.banded_lu`) factorizes on the
    host when it is invoked; each of its applies copies the vector to the
    host once and back once.  ``callback(u, res, n_res)`` fires after every
    residual evaluation, u₀'s included (on the df32 path with the hi
    words); ``verbose > 0`` prints one line per outer iteration.

    Precision modes, as :func:`newton_krylov_jit`: ``residual_dtype``
    evaluates the outer residual in a higher dtype; ``krylov_dtype`` runs
    the linearization and the Krylov loop in a lower one; ``residual_df``
    carries the state as a df32 pair with a double-word acceptance residual
    (it excludes ``residual_dtype`` and ``linesearch``), and ``floor_rtol``
    clamps its tolerance to the measured representation floor.
    ``linesearch="armijo"`` backtracks on ‖F‖ (:func:`_armijo_step`).

    ``jit_step`` is accepted for the JAX package's signature and changes
    nothing: the port has no compiled step.

    Returns ``(u, NewtonInfo)`` with Python numbers in ``stats``, the
    wall-clock seconds ``t`` and no history.  When ‖F‖ goes NaN/Inf the
    solve stops, prints an error and reports ``solved=False``; the counts
    then exclude the step that blew up.
    """
    del jit_step
    require_eager("newton_krylov")
    space = space or EuclideanSpace()
    forcing = _resolve_forcing(forcing)
    krylov_kwargs = dict(krylov_kwargs or {})
    if precond_refresh not in ("outer", "once"):
        raise ValueError(f"unknown precond_refresh {precond_refresh!r}")

    t0 = time.perf_counter()
    s = _setup(F, u0, p, space=space, algo=algo, krylov_kwargs=krylov_kwargs,
               tol_rel=tol_rel, tol_abs=tol_abs, krylov_dtype=krylov_dtype,
               residual_df=residual_df, residual_dtype=residual_dtype,
               linesearch=linesearch, floor_rtol=floor_rtol)

    def report(u, res, n):
        if callback is not None:
            if residual_df is not None:
                callback(u.hi, res.hi, n)
            else:
                callback(u, res, n)

    u, res, n_res_t = s.u0, s.res0, s.n_res0
    with span("read"):
        n_res, tol = float(n_res_t), float(s.tol)
    report(u, res, n_res)
    eta = forcing.initial() if forcing is not None else None
    if verbose > 0:
        print(f"[newton_krylov] algo={algo} res0={n_res:.6e} tol={tol:.3e} "
              f"(rel={tol_rel} abs={tol_abs}) eta0={eta}")

    m_static = n_static = None
    if precond_refresh == "once" and (M is not None or N is not None):
        m_static, n_static = _static_preconditioners(F, p, s, M, N, residual_df)

    stats = Stats(0, 0, n_res)
    while n_res > tol and stats.outer_iterations <= max_niter:
        with span("outer"):
            u, res, n_res_t, niter = _newton_step(
                F, p, s, u, res, n_res_t, eta, space=space, algo=algo,
                krylov_kwargs=krylov_kwargs, M=M, N=N, m_static=m_static,
                n_static=n_static, residual_df=residual_df,
                residual_dtype=residual_dtype, linesearch=linesearch)
        with span("read"):
            n_res_prior, n_res = n_res, float(n_res_t)
        report(u, res, n_res)
        if not math.isfinite(n_res):
            print(f"[newton_krylov] ERROR: inner solver blew up, stats={stats}")
            break
        if forcing is not None:
            eta = forcing.host_update(eta, tol, n_res, n_res_prior)
            if verbose > 0 and niter == 0:
                print("[newton_krylov] inexact Newton accepted step with 0 "
                      f"inner iters, eta={eta}")
        stats = Stats(stats.outer_iterations + 1,
                      stats.inner_iterations + niter, n_res)
        if verbose > 0:
            print(f"[newton_krylov] outer={stats.outer_iterations} "
                  f"|F|={n_res:.6e} eta={eta} inner+={niter}")

    return _finish(s, u), NewtonInfo(
        solved=n_res <= tol, stats=stats, t=time.perf_counter() - t0,
        floor_limited=bool(s.floor_limited))


@spanned("solve")
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
    """Solve F(u, p) = 0 by inexact Newton–Krylov, with the loop state on
    the device.

    Returns ``(u, NewtonInfo)``: ``solved`` and ``stats.n_res`` are device
    tensors, the iteration counts Python ints (0-d tensors in an export),
    ``t`` the wall-clock seconds
    of the solve and ``history`` a ``(max_niter + 2,)`` residual-norm trace
    padded with NaN.

    Precision modes:

    * ``residual_dtype``: the outer residual and its norm in a higher dtype
      (typically float64 for a float32 state), state and inner loop in the
      state dtype.
    * ``krylov_dtype``: iterative refinement — the state and the outer
      residual stay in the state dtype, the linearization and the Krylov
      loop run in ``krylov_dtype``.
    * ``residual_df``: a df32 evaluation of the same residual,
      ``residual_df(DF(u), p) -> DF``.  The state is carried as a df32 pair,
      the inner loop (``krylov_dtype``, default f32) takes ``hi`` as its
      RHS.  An f64 ``u0`` is split at the boundary and the result returned
      as f64 (hi + lo); otherwise the hi word is returned.  It excludes
      ``residual_dtype`` and ``linesearch``.
      ``floor_rtol`` clamps the tolerance to ``floor_rtol`` times the
      measured df32 representation floor
      (:func:`~newtonkrylov_tpu_torch.df32.floor_estimate`);
      ``info.floor_limited`` reports whether the clamp engaged.

    ``linesearch="armijo"`` backtracks on ‖F‖ (:func:`_armijo_step`).
    ``precond_refresh``: ``"outer"`` re-invokes the ``M``/``N`` factories
    every outer iteration; ``"once"`` invokes them on the u₀ operator.
    Host-side factories run here too, as in :func:`newton_krylov`.
    """
    space = space or EuclideanSpace()
    forcing = _resolve_forcing(forcing)
    krylov_kwargs = dict(krylov_kwargs or {})
    if precond_refresh not in ("outer", "once"):
        raise ValueError(f"unknown precond_refresh {precond_refresh!r}")

    t0 = time.perf_counter()
    s = _setup(F, u0, p, space=space, algo=algo, krylov_kwargs=krylov_kwargs,
               tol_rel=tol_rel, tol_abs=tol_abs, krylov_dtype=krylov_dtype,
               residual_df=residual_df, residual_dtype=residual_dtype,
               linesearch=linesearch, floor_rtol=floor_rtol)
    dtype, device = s.n_res0.dtype, s.n_res0.device
    eta = torch.full((), forcing.initial() if forcing is not None else 0.0,
                     dtype=dtype, device=device)
    hist = record(torch.full((max_niter + 2,), float("nan"), dtype=dtype,
                             device=device), 0, s.n_res0)

    m_static = n_static = None
    if precond_refresh == "once" and (M is not None or N is not None):
        m_static, n_static = _static_preconditioners(F, p, s, M, N, residual_df)

    tol, limit = s.tol, counter(s.n_res0, max_niter)

    def cond(outer, inner, u, res, n_res, eta, hist, blown):
        return (outer <= limit) & (n_res > tol) & ~blown

    def body(outer, inner, u, res, n_res, eta, hist, blown):
        # The acceptance residual is carried from the previous outer's
        # evaluation: one high-precision residual per outer.
        u_new, res, n_new, niter = _newton_step(
            F, p, s, u, res, n_res, eta if forcing is not None else None,
            space=space, algo=algo, krylov_kwargs=krylov_kwargs, M=M, N=N,
            m_static=m_static, n_static=n_static, residual_df=residual_df,
            residual_dtype=residual_dtype, linesearch=linesearch)
        blown = ~torch.isfinite(n_new)
        if forcing is not None:
            eta = forcing(eta, tol, n_new, n_res)
        return (outer + 1, inner + niter, u_new, res, n_new, eta,
                record(hist, outer + 1, n_new), blown)

    outer, inner, u, _, n_res, _, hist, blown = while_loop(cond, body, (
        counter(s.n_res0), counter(s.n_res0), s.u0, s.res0, s.n_res0, eta,
        hist, torch.zeros((), dtype=torch.bool, device=device)), name="outer")

    info = NewtonInfo(
        solved=(n_res <= tol) & ~blown,
        stats=Stats(outer, inner, n_res),
        t=time.perf_counter() - t0,
        history=hist,
        floor_limited=s.floor_limited,
    )
    return _finish(s, u), info

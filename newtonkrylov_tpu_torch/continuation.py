"""Pseudo-transient continuation (Ψtc): globalized Newton–Krylov.

Counterpart of ``newtonkrylov_tpu/continuation.py`` (Kelley 2003, ``ptcsol``;
Kelley & Keyes, SINUM 35(2), 1998).  It solves for the steady state of
``du/dτ = −F(u)`` by backward-Euler pseudo-time steps whose linear system
goes through the Newton drivers' Krylov machinery:

    (δₖ⁻¹ I + F′(uₖ)) d = F(uₖ),      uₖ₊₁ = uₖ − d,

with the pseudo-timestep grown by switched evolution relaxation (SER):

    δₖ₊₁ = min(δ_max, δₖ · ‖F(uₖ)‖ / ‖F(uₖ₊₁)‖).

Far from the root δ is small and the iteration follows the pseudo-time
flow; near it δ → δ_max and the step is an inexact Newton step.  The step
is the Newton drivers' own (:func:`~newtonkrylov_tpu_torch.newton._newton_step`)
on the shifted operator; the loop keeps its state on the device and reads
one boolean back per step, as
:func:`~newtonkrylov_tpu_torch.newton.newton_krylov_jit` does, and exports
as a ``while_loop`` in the same way (:mod:`~newtonkrylov_tpu_torch.exportable`).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch

from .exportable import counter, record, while_loop
from .forcing import Fixed, Forcing
from .newton import (NewtonInfo, Stats, _finish, _newton_step,
                     _resolve_forcing, _setup)
from .spaces import EuclideanSpace, VectorSpace

__all__ = ["pseudo_transient"]


def pseudo_transient(
    F: Callable,
    u0: Any,
    p: Any = None,
    *,
    delta0: float = 1.0,
    delta_max: float = 1.0e12,
    tol_rel: float = 1.0e-6,
    tol_abs: float = 1.0e-12,
    max_steps: int = 200,
    forcing: Optional[Forcing] = Fixed(1.0e-2),
    algo: str = "gmres",
    M: Optional[Callable] = None,
    N: Optional[Callable] = None,
    krylov_kwargs: Optional[dict] = None,
    space: Optional[VectorSpace] = None,
    krylov_dtype=None,
    residual_df: Optional[Callable] = None,
    floor_rtol: Optional[float] = 2.0,
):
    """Solve F(u, p) = 0 by Ψtc with SER.

    For problems where plain Newton from the available start diverges —
    ``F(x) = arctan(x)`` from |x₀| ≳ 1.4, or steady states near the Bratu
    fold.  Near the root it is inexact Newton, and the tolerance is the
    Newton drivers': ``tol = tol_rel·‖F(u₀)‖ + tol_abs``.

    * **Sign.**  Ψtc follows ``du/dτ = −F(u)`` and converges to steady
      states that are stable for that flow: for the Bratu residual
      ``Δu + λeᵘ`` pass ``−residual``.  A start in the flow's blow-up basin
      blows up, and the NaN/Inf abort reports ``solved=False``.
    * **δ₀ in the residual's time unit.**  A Δx²-scaled residual evolves in
      Δx²-scaled pseudo-time: take ``delta0 ≈ 1/Δx²``.

    ``delta_max`` caps the SER growth; at it the steps are Newton steps.
    ``max_steps`` is inclusive, as the Newton drivers' ``max_niter``: up to
    ``max_steps + 1`` steps run.  ``forcing`` is ``Fixed(1e-2)`` by default.
    The factories ``M``/``N`` are invoked every step on the shifted
    operator ``δ⁻¹I + J``, so probing factories see the shifted diagonal.
    ``krylov_dtype`` and ``residual_df`` (with ``floor_rtol``) are the
    precision modes of :func:`~newtonkrylov_tpu_torch.newton.newton_krylov_jit`.

    Returns ``(u, NewtonInfo)``: ``history`` is the NaN-padded ‖F‖ trace,
    ``stats.outer_iterations`` the number of pseudo-time steps.
    """
    space = space or EuclideanSpace()
    forcing = _resolve_forcing(forcing)
    krylov_kwargs = dict(krylov_kwargs or {})

    t0 = time.perf_counter()
    s = _setup(F, u0, p, space=space, algo=algo, krylov_kwargs=krylov_kwargs,
               tol_rel=tol_rel, tol_abs=tol_abs, krylov_dtype=krylov_dtype,
               residual_df=residual_df, floor_rtol=floor_rtol)
    dtype, device = s.n_res0.dtype, s.n_res0.device
    scalar = dict(dtype=dtype, device=device)
    eta = torch.full((), forcing.initial() if forcing is not None else 0.0,
                     **scalar)
    delta = torch.full((), delta0, **scalar)
    delta_cap = torch.full((), delta_max, **scalar)
    tiny = torch.full((), torch.finfo(dtype).tiny, **scalar)
    hist = record(torch.full((max_steps + 2,), float("nan"), **scalar), 0,
                  s.n_res0)
    tol, limit = s.tol, counter(s.n_res0, max_steps)

    def cond(outer, inner, u, res, n_res, delta, eta, hist, blown):
        return (outer <= limit) & (n_res > tol) & ~blown

    def body(outer, inner, u, res, n_res, delta, eta, hist, blown):
        u, res, n_new, niter = _newton_step(
            F, p, s, u, res, n_res, eta if forcing is not None else None,
            space=space, algo=algo, krylov_kwargs=krylov_kwargs, M=M, N=N,
            residual_df=residual_df, shift=1.0 / delta)
        blown = ~torch.isfinite(n_new)
        # SER: δ grows by the residual's reduction; a bad step (‖F‖ up)
        # shrinks it by the same rule, back toward the pseudo-time flow
        delta = torch.minimum(delta_cap,
                              delta * n_res / torch.maximum(n_new, tiny))
        if forcing is not None:
            eta = forcing(eta, tol, n_new, n_res)
        return (outer + 1, inner + niter, u, res, n_new, delta, eta,
                record(hist, outer + 1, n_new), blown)

    outer, inner, u, _, n_res, _, _, hist, blown = while_loop(cond, body, (
        counter(s.n_res0), counter(s.n_res0), s.u0, s.res0, s.n_res0, delta,
        eta, hist, torch.zeros((), dtype=torch.bool, device=device)),
        name="outer")

    info = NewtonInfo(
        solved=(n_res <= tol) & ~blown,
        stats=Stats(outer, inner, n_res),
        t=time.perf_counter() - t0,
        history=hist,
        floor_limited=s.floor_limited,
    )
    return _finish(s, u), info

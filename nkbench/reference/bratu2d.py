"""Plain float64 reference of the 2-D Bratu (solid-fuel ignition) problem.

The problem of PETSc's SNES tutorial ex5 and MINPACK-2's SFI problem:
``Δu + λ·eᵘ = 0`` on the unit square with zero Dirichlet boundary values,
discretized by the 5-point stencil on an n × n interior grid of spacing
``h = 1/(n+1)``, in the h²-scaled form

    F(u)ᵢⱼ = u_{i-1,j} + u_{i+1,j} + u_{i,j-1} + u_{i,j+1} − 4·uᵢⱼ + h²·λ·e^{uᵢⱼ}

(neighbours outside the grid are 0).  :func:`judge` holds a returned state
to the configured acceptance: ``‖F(u)‖₂`` against
``max(tol_rel·‖F(u₀)‖₂ + tol_abs, floor_rtol·floor(u₀))``, where
``floor`` is the representation floor of a state carried as a pair of
float32 words, measured as the configuration states it: the response of
the Jacobian to a perturbation of ``2⁻⁴⁷·|u|`` with signs alternating
along one axis (the larger of the two axes), over 4.  Every request starts
from the sources' own initial guess, :func:`initial_guess`.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
PAIR_EPS = 2.0 ** -47  # unit round-off of a float32 pair (hi + lo)
FLOOR_CALIBRATION = 4.0


def spacing(n: int) -> float:
    return 1.0 / (n + 1)


def neighbour_sum(u: torch.Tensor) -> torch.Tensor:
    """Sum of the four neighbours, zero outside the grid."""
    out = torch.zeros_like(u)
    out[1:, :] += u[:-1, :]
    out[:-1, :] += u[1:, :]
    out[:, 1:] += u[:, :-1]
    out[:, :-1] += u[:, 1:]
    return out


def residual(u: torch.Tensor, lam: float) -> torch.Tensor:
    """F(u) in float64 (module docstring)."""
    u = u.to(F64)
    h = spacing(u.shape[-1])
    return neighbour_sum(u) - 4.0 * u + (h * h * lam) * torch.exp(u)


def jvp(u: torch.Tensor, v: torch.Tensor, lam: float) -> torch.Tensor:
    """J(u)·v = neighbours(v) − 4v + h²λ·eᵘ·v, float64."""
    u, v = u.to(F64), v.to(F64)
    h = spacing(u.shape[-1])
    return neighbour_sum(v) - 4.0 * v + (h * h * lam) * torch.exp(u) * v


def floor(u: torch.Tensor, lam: float) -> float:
    """The float32-pair representation floor of ‖F‖ at ``u``."""
    u = u.to(F64)
    n0, n1 = u.shape
    alt0 = (1 - 2 * (torch.arange(n0, device=u.device) % 2)).to(F64)[:, None]
    alt1 = (1 - 2 * (torch.arange(n1, device=u.device) % 2)).to(F64)[None, :]
    worst = 0.0
    for signs in (alt1.expand(n0, n1), alt0.expand(n0, n1)):
        delta = u.abs() * PAIR_EPS * signs
        worst = max(worst, float(torch.linalg.vector_norm(jvp(u, delta, lam))))
    return worst / FLOOR_CALIBRATION


def tolerance(u0: torch.Tensor, lam: float, tol_rel: float, tol_abs: float,
              floor_rtol) -> float:
    """The acceptance tolerance the configuration states for a solve from
    ``u0``: ``tol_rel·‖F(u₀)‖ + tol_abs``, raised to ``floor_rtol`` times
    the representation floor at ``u0`` where ``floor_rtol`` is given."""
    tol = tol_rel * float(torch.linalg.vector_norm(residual(u0, lam))) + tol_abs
    if floor_rtol is not None:
        tol = max(tol, floor_rtol * floor(u0, lam))
    return tol


def initial_guess(problem: dict, n: int, device, block=None) -> torch.Tensor:
    """The starting state the problem's source states, on the n × n
    interior (float64, on ``device``); with ``block`` (a pair of slices of
    the rows and columns) only that block of it, as a rank of a sharded
    solve forms its own.

    ``"ex5"``: PETSc SNES ex5's ``FormInitialGuess`` and MINPACK-2's
    ``dsfifg`` (task ``'XS'``), ``u₀ = λ/(λ+1)·sqrt(d)`` with ``d`` the
    smaller of the point's distances to the boundary along x and along y.
    """
    if problem.get("initial_guess") != "ex5":
        raise ValueError(f"unknown initial guess "
                         f"{problem.get('initial_guess')!r}")
    lam = float(problem["lam"])
    i = torch.arange(1, n + 1, dtype=F64, device=device)
    d = torch.minimum(i, n + 1 - i) / (n + 1)
    rows, cols = (d, d) if block is None else (d[block[0]], d[block[1]])
    return (lam / (lam + 1.0)) * torch.sqrt(torch.minimum(rows[:, None],
                                                          cols[None, :]))


def judge(u: torch.Tensor, u0: torch.Tensor, problem: dict, recipe: dict
          ) -> dict:
    """``‖F(u)‖₂`` of a returned state, the stated tolerance of its solve,
    and their ratio (``res_ratio``: at most about 1 for a sound answer)."""
    lam = float(problem["lam"])
    if tuple(u.shape) != tuple(u0.shape) or not bool(torch.isfinite(u).all()):
        return {"res": math.inf, "tol": math.nan, "res_ratio": math.inf}
    res = float(torch.linalg.vector_norm(residual(u, lam)))
    tol = tolerance(u0, lam, float(recipe["tol_rel"]),
                    float(recipe["tol_abs"]), recipe.get("floor_rtol"))
    return {"res": res, "tol": tol, "res_ratio": res / tol}

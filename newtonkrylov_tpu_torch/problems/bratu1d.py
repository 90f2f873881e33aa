"""1-D Bratu problem ``y″ + λeʸ = 0`` with zero Dirichlet boundaries.

Counterpart of ``newtonkrylov_tpu/problems/bratu1d.py``: the reference's
configuration is N = 10⁴, λ = 3.51382, Δx = 1/(N+1), u₀ = sin(πx), with the
closed-form solution through cosh (θ = 4.79173).  Its recommended solver is
CG; plain GMRES stalls.

Two residual forms with the same roots:

* :func:`residual` — the reference's scaling ``(yᵣ−2y+yₗ)/Δx² + λeʸ``, which
  needs f64 at N = 10⁴;
* :func:`residual_scaled` — multiplied through by Δx²,
  ``(yᵣ−2y+yₗ) + Δx²λeʸ``: the same Newton counts under Eisenstat–Walker
  forcing, and :func:`residual_scaled_df` its df32 acceptance residual.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import df32 as dd
from ..utils import default_device

__all__ = [
    "Params", "default_config", "residual", "residual_scaled",
    "residual_scaled_df", "true_solution", "initial_guess", "grid",
]

N_DEFAULT = 10_000
LAMBDA_DEFAULT = 3.51382
THETA = 4.79173  # for λ = 3.51382; the second solution has θ = 4.8057


class Params(NamedTuple):
    dx: float
    lam: float


def default_config(n: int = N_DEFAULT, lam: float = LAMBDA_DEFAULT) -> Params:
    return Params(dx=1.0 / (n + 1), lam=lam)


def grid(n: int = N_DEFAULT, dtype=torch.float64, device=None):
    """Interior grid x ∈ (Δx, 1−Δx), on ``device`` (by default the card)."""
    dx = 1.0 / (n + 1)
    return torch.from_numpy(np.linspace(dx, 1.0 - dx, n)).to(
        device=device or default_device(), dtype=dtype)


def initial_guess(n: int = N_DEFAULT, dtype=torch.float64, device=None):
    """u₀ = sin(πx)."""
    return torch.sin(math.pi * grid(n, dtype, device))


def _stencil(y):
    y_l = torch.cat([y.new_zeros(1), y[:-1]])
    y_r = torch.cat([y[1:], y.new_zeros(1)])
    return y_r - 2.0 * y + y_l


def residual(y, p: Params):
    """The reference's scaling: y″ + λeʸ with zero boundary values."""
    return _stencil(y) / (p.dx * p.dx) + p.lam * torch.exp(y)


def residual_scaled(y, p: Params):
    """Δx²-scaled form: (yᵣ−2y+yₗ) + Δx²λeʸ."""
    return _stencil(y) + (p.dx * p.dx) * p.lam * torch.exp(y)


def residual_scaled_df(y, p: Params):
    """The Δx²-scaled residual in df32 (``y`` a DF pair): exact two-sum
    neighbour sums and the exponent-shifted Δx²λeʸ."""
    yp = dd.df_map(lambda w: torch.cat([w.new_zeros(1), w, w.new_zeros(1)]), y)
    s = dd.neighbor_sum(yp, [(-1,), (1,)])
    s = dd.add(s, dd.scale_pow2(y, -2.0))
    return dd.add(s, dd.scaled_exp(y, float(p.dx) * float(p.dx) * float(p.lam)))


def true_solution(x, theta: float = THETA):
    """The closed-form solution at the points ``x``."""
    return -2.0 * torch.log(torch.cosh(theta * (x - 0.5) / 2.0)
                            / math.cosh(theta / 4.0))

"""Harmonic-oscillator ODE (examples/spring.jl).

Counterpart of ``newtonkrylov_tpu/problems/spring.py``:
``dx/dt = v, dv/dt = −γ²x`` with γ = √(k/m); defaults k=2, m=1, x₀=0.1,
v₀=0 (examples/spring.jl:14-40).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import df32 as dd
from ..utils import default_device

__all__ = ["Params", "default_config", "rhs", "rhs_df", "initial_condition",
           "exact_solution"]


class Params(NamedTuple):
    gamma: float


def default_config(k: float = 2.0, m: float = 1.0) -> Params:
    return Params(gamma=math.sqrt(k / m))


def initial_condition(x0: float = 0.1, v0: float = 0.0, dtype=torch.float64,
                      device=None):
    """[x₀, v₀] on ``device`` (by default the card)."""
    return torch.tensor([x0, v0], dtype=dtype, device=device or default_device())


def rhs(u, p: Params, t=None):
    """f!(du, u, (γ,), t) (examples/spring.jl:14-18)."""
    return torch.stack([u[1], -(p.gamma * p.gamma) * u[0]])


def rhs_df(u, p: Params, t=None):
    """df32 RHS (``u`` a DF pair): −γ² enters as a split constant; the
    component shuffle is a placement, exact per word."""
    ax = dd.scale_const(dd.df_map(lambda w: w[0:1], u),
                        -float(p.gamma) * float(p.gamma))
    v = dd.df_map(lambda w: w[1:2], u)
    return dd.DF(torch.cat([v.hi, ax.hi]), torch.cat([v.lo, ax.lo]))


def exact_solution(t, p: Params, x0: float = 0.1, v0: float = 0.0):
    """x(t) = x₀cos(γt) + (v₀/γ)sin(γt), as a float64 tensor."""
    g = p.gamma
    gt = torch.as_tensor(g * t, dtype=torch.float64)
    return x0 * torch.cos(gt) + (v0 / g) * torch.sin(gt)

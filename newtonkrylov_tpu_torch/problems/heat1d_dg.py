"""1-D heat equation via DG / upwind operator composition
(examples/heat_1D_DG.jl).

Counterpart of ``newtonkrylov_tpu/problems/heat1d_dg.py``:
``du = D1m @ (D1p @ u)`` with (D1m, D1p) a periodic Legendre-DG pair or
periodic upwind finite-difference operators (:mod:`..ops.sbp`).  The
Jacobian operator differentiates straight through the matrices.

Defaults mirror the reference: DG with polydeg 3 × 40 elements on [0, 1];
upwind with 120 nodes, accuracy order 3; u₀ = sin(πx).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import df32 as dd
from ..ops.sbp import (
    UniformPeriodicMesh1D,
    couple_discontinuously,
    legendre_derivative_operator,
    periodic_upwind_operators,
)
from ..utils import default_device

__all__ = ["Params", "dg_config", "upwind_config", "rhs", "rhs_df",
           "initial_condition"]


class Params(NamedTuple):
    D1m: torch.Tensor
    D1p: torch.Tensor
    x: torch.Tensor


def dg_config(polydeg: int = 3, elements: int = 40, xmin: float = 0.0,
              xmax: float = 1.0, *, dtype=torch.float64, device=None) -> Params:
    """Legendre-DG pair coupled with minus/plus upwind fluxes
    (examples/heat_1D_DG.jl:17-25), on ``device`` (by default the card)."""
    local_op = legendre_derivative_operator(polydeg + 1)
    mesh = UniformPeriodicMesh1D(xmin, xmax, elements)
    x, D1m = couple_discontinuously(local_op, mesh, "minus", dtype=dtype,
                                    device=device)
    _, D1p = couple_discontinuously(local_op, mesh, "plus", dtype=dtype,
                                    device=device)
    return Params(D1m=D1m, D1p=D1p, x=x)


def upwind_config(nnodes: int = 120, accuracy_order: int = 3, xmin: float = 0.0,
                  xmax: float = 1.0, *, dtype=torch.float64, device=None) -> Params:
    """Periodic upwind FD pair (examples/heat_1D_DG.jl:134-141)."""
    device = device or default_device()
    dx = (xmax - xmin) / nnodes
    Dm, Dp = periodic_upwind_operators(nnodes, dx, accuracy_order, dtype=dtype,
                                       device=device)
    x = xmin + dx * torch.arange(nnodes, dtype=dtype, device=device)
    return Params(D1m=Dm, D1p=Dp, x=x)


def initial_condition(p: Params):
    """f(x) = sin(πx) (examples/heat_1D_DG.jl:39)."""
    return torch.sin(math.pi * p.x)


def rhs(u, p: Params, t=None):
    """du = D1m @ (D1p @ u) (examples/heat_1D_DG.jl:32-36)."""
    return p.D1m @ (p.D1p @ u)


def rhs_df(u, p: Params, t=None):
    """du in df32 arithmetic (``u`` a DF pair): the composition as two
    double-word matvecs (:func:`~newtonkrylov_tpu_torch.df32.df_matvec`).
    Pair with :func:`~newtonkrylov_tpu_torch.timestep.implicit_euler_df`."""
    Dm = dd.df_from_f64(p.D1m)
    Dp = dd.df_from_f64(p.D1p)
    return dd.df_matvec(Dm, dd.df_matvec(Dp, u))

"""2-D diffusion ``uₜ = a·Δu`` on the unit square (examples/heat_2D.jl).

Counterpart of ``newtonkrylov_tpu/problems/heat2d.py``.  The state is the
(N, M) interior; ghosts are materialized by a zero or wrap-around pad, so
every reduction runs over exactly the interior.

Default scenario (examples/heat_2D.jl:64-96): a = 0.01, N = M = 40,
Δx = Δy = 1/(N+1), Δt = Δx²Δy²/(2a(Δx²+Δy²)), u₀ = sin(πx)sin(πy).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import df32 as dd
from ..ops.stencil import laplacian_2d, pad_dirichlet, pad_periodic
from ..utils import default_device

__all__ = [
    "Params", "default_config", "rhs", "rhs_df", "rhs_df_padded",
    "initial_condition", "grid", "stable_dt",
]


class Params(NamedTuple):
    a: float
    dx: float
    dy: float
    bc: str  # "zero" | "periodic"


def default_config(n: int = 40, a: float = 0.01, bc: str = "zero") -> Params:
    d = 1.0 / (n + 1)
    return Params(a=a, dx=d, dy=d, bc=bc)


def stable_dt(p: Params) -> float:
    """The reference's explicit-stability step (examples/heat_2D.jl:72)."""
    dx2, dy2 = p.dx * p.dx, p.dy * p.dy
    return dx2 * dy2 / (2.0 * p.a * (dx2 + dy2))


def grid(n: int = 40, dtype=torch.float64, device=None):
    """(X, Y) interior node coordinates, ``indexing="ij"``, on ``device``
    (by default the card)."""
    d = 1.0 / (n + 1)
    x = torch.from_numpy(np.linspace(d, 1.0 - d, n)).to(
        device=device or default_device(), dtype=dtype)
    return torch.meshgrid(x, x, indexing="ij")


def initial_condition(n: int = 40, dtype=torch.float64, device=None):
    """u₀ = sin(πx)sin(πy) (examples/heat_2D.jl:78-88)."""
    X, Y = grid(n, dtype, device)
    return torch.sin(math.pi * X) * torch.sin(math.pi * Y)


def _pad(p: Params):
    return pad_dirichlet if p.bc == "zero" else pad_periodic


def rhs(u, p: Params, t=None):
    """du = a·Δu over the (N, M) interior (diffusion!,
    examples/heat_2D.jl:41-62)."""
    return p.a * laplacian_2d(_pad(p)(u), p.dx, p.dy)


def rhs_df(u, p: Params, t=None):
    """a·Δu in df32 arithmetic (``u`` a :class:`~newtonkrylov_tpu_torch.df32.DF`
    pair): the neighbour − 2u cancellation in exact two-sum chains, a/Δx²
    as a split constant.  Pair with
    :func:`~newtonkrylov_tpu_torch.timestep.implicit_euler_df`."""
    return rhs_df_padded(dd.df_map(_pad(p), u), u, p, t)


def rhs_df_padded(up, u, p: Params, t=None):
    """df32 RHS core on a pre-padded DF block."""
    m2u = dd.scale_pow2(u, -2.0)
    lx = dd.add(dd.add(dd.shift(up, 1, 0), dd.shift(up, -1, 0)), m2u)
    ly = dd.add(dd.add(dd.shift(up, 0, 1), dd.shift(up, 0, -1)), m2u)
    return dd.add(
        dd.scale_const(lx, float(p.a) / (float(p.dx) * float(p.dx))),
        dd.scale_const(ly, float(p.a) / (float(p.dy) * float(p.dy))),
    )

"""Steady 2-D convection–diffusion (viscous Burgers type) — nonsymmetric.

Counterpart of ``newtonkrylov_tpu/problems/convdiff2d.py``::

    Δu − c·u·(u_x + u_y) + g = 0   on the unit square, zero Dirichlet BCs,

with the 5-point Laplacian and central first differences.  The convection
term makes the Jacobian non-self-adjoint, so this is the library's problem
where ``algo="gmres"`` is required rather than optional.  The forcing is
manufactured from the discrete operator: ``default_config`` stores
``b = −L_h(u*)`` for u* = sin(πx)sin(πy) on the grid, so u* is the exact
discrete root.  The residual is the Δx²-scaled form
``(Σ neighbours − 4u) − (c·Δx/2)·u·(δ_x u + δ_y u) + b``.

The JAX package's recipe at moderate convection (c ≲ 4, the default 2):
``algo="gmres"``, ``M=fft_poisson()``, ``krylov_kwargs={"restart": None,
"itmax": ...}``, with ``forcing=None``; its refined form adds
``krylov_dtype=float32`` and ``residual_df=residual_scaled_df``.

Entry points that create tensors take a ``dtype`` (float64 by default) and
a ``device`` (by default the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import df32 as dd
from ..ops.stencil import pad_dirichlet
from ..utils import default_device
from . import bratu2d

__all__ = [
    "Params",
    "default_config",
    "residual_scaled",
    "residual_scaled_padded",
    "residual_scaled_df",
    "residual_scaled_df_padded",
    "initial_guess",
    "manufactured_solution",
    "grid",
]

N_DEFAULT = 128
C_DEFAULT = 2.0


class Params(NamedTuple):
    dx: float
    c: float
    b: torch.Tensor  # manufactured forcing, (n, n), Δx²-scaled


def grid(n: int = N_DEFAULT, dtype=torch.float64, device=None):
    """(X, Y) interior coordinates, ``indexing="ij"``."""
    return bratu2d.grid(n, dtype, device)


def manufactured_solution(n: int = N_DEFAULT, dtype=torch.float64, device=None):
    """u* = sin(πx)sin(πy) on the interior grid — the exact discrete root
    (the Bratu problem's sin-bump start)."""
    return bratu2d.initial_guess(n, dtype, device)


def _operator_scaled(up, u, c: float, dx: float):
    """Δx²-scaled discrete operator L_h(u) (no forcing): 5-point stencil
    minus central-difference convection, reading one ghost ring of ``up``."""
    stencil = up[2:, 1:-1] + up[:-2, 1:-1] + up[1:-1, 2:] + up[1:-1, :-2] - 4.0 * u
    d0 = up[2:, 1:-1] - up[:-2, 1:-1]
    d1 = up[1:-1, 2:] - up[1:-1, :-2]
    return stencil - (0.5 * dx * c) * u * (d0 + d1)


def default_config(n: int = N_DEFAULT, c: float = C_DEFAULT,
                   dtype=torch.float64, device=None) -> Params:
    """Params with the manufactured forcing b = −L_h(u*) in ``dtype``; in
    float64 the root is exact, in float32 exact to the rounding of b."""
    dx = 1.0 / (n + 1)
    us = manufactured_solution(n, dtype, device)
    b = -_operator_scaled(pad_dirichlet(us), us, c, dx)
    return Params(dx=dx, c=c, b=b)


def initial_guess(n: int = N_DEFAULT, dtype=torch.float64, device=None):
    """Zero start (detuned from the manufactured root)."""
    return torch.zeros((n, n), dtype=dtype,
                       device=device or default_device())


def residual_scaled(u, p: Params):
    """Δx²-scaled residual L_h(u) + b; root at the manufactured u*."""
    return residual_scaled_padded(pad_dirichlet(u), p)


def residual_scaled_padded(up, p: Params):
    """Residual core on a pre-padded block."""
    u = up[1:-1, 1:-1]
    return _operator_scaled(up, u, p.c, p.dx) + p.b.to(u.dtype)


def _b_df(p: Params) -> dd.DF:
    if p.b.dtype == torch.float64:
        return dd.df_from_f64(p.b)
    return dd.DF(p.b, torch.zeros_like(p.b))


def residual_scaled_df(u: dd.DF, p: Params) -> dd.DF:
    """Δx²-scaled residual in df32 arithmetic (``u`` a DF pair): the stencil
    cancellation in exact two-sum chains, the convection product a
    double-word multiply, the forcing an f64-split DF constant."""
    up = dd.DF(pad_dirichlet(u.hi), pad_dirichlet(u.lo))
    return residual_scaled_df_padded(up, u, p)


def residual_scaled_df_padded(up: dd.DF, u: dd.DF, p: Params) -> dd.DF:
    """df32 residual core on a pre-padded DF block."""
    s = dd.neighbor_sum(up, [(1, 0), (-1, 0), (0, 1), (0, -1)])
    s = dd.add(s, dd.scale_pow2(u, -4.0))
    d0 = dd.sub(dd.shift(up, 1, 0), dd.shift(up, -1, 0))
    d1 = dd.sub(dd.shift(up, 0, 1), dd.shift(up, 0, -1))
    conv = dd.scale_const(dd.mul(u, dd.add(d0, d1)), -0.5 * p.dx * p.c)
    return dd.add(dd.add(s, conv), _b_df(p))

"""Steady quasilinear diffusion: a Jacobian that varies in every stencil slot.

Counterpart of ``newtonkrylov_tpu/problems/nldiff2d.py``::

    ∇·(D(u)∇u) + g = 0  on the unit square,  D(u) = 1 + u²,  zero Dirichlet,

in conservative flux form with arithmetic-mean face diffusivities,

    F_ij = Σ_faces D_face·(u_nbr − u_ij)  (Δx²-scaled)  + b_ij,
    D_{i+1/2,j} = (D(u_ij) + D(u_{i+1,j})) / 2.

All five coefficient fields of its Jacobian depend on the state and it is
nonsymmetric: the case :func:`~newtonkrylov_tpu_torch.mg.probe_5point_general`
recovers and the constant-coefficient DST/Chebyshev factories cannot
represent.  The JAX package's recipes: GMRES with ``precond.adi(4)`` or
``mg.multigrid2d_general()``, ``forcing=None``; refined with
``krylov_dtype=float32`` and ``residual_df=residual_scaled_df``.

The forcing is manufactured from the discrete operator: with
u* = amp·sin(πx)sin(πy), ``default_config`` stores ``b = −L_h(u*)``, so u*
is the exact discrete root.  ``amp`` sets the diffusivity contrast
(max D / min D = 1 + amp²).  Entry points that create tensors take a
``dtype`` (float64 by default) and a ``device`` (by default the card).
"""

from __future__ import annotations

import math
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
    "initial_guess",
    "manufactured_solution",
    "grid",
]

N_DEFAULT = 64
AMP_DEFAULT = 2.0


class Params(NamedTuple):
    dx: float
    b: torch.Tensor  # manufactured forcing, (n, n), Δx²-scaled


def grid(n: int = N_DEFAULT, dtype=torch.float64, device=None):
    """(X, Y) interior coordinates, ``indexing="ij"``."""
    return bratu2d.grid(n, dtype, device)


def manufactured_solution(n: int = N_DEFAULT, amp: float = AMP_DEFAULT,
                          dtype=torch.float64, device=None):
    """u* = amp·sin(πx)sin(πy), the exact discrete root."""
    X, Y = grid(n, dtype, device)
    return amp * torch.sin(math.pi * X) * torch.sin(math.pi * Y)


def _operator_scaled(up):
    """Δx²-scaled flux-form operator Σ_faces D_face·(u_nbr − u) on a padded
    block (the Dirichlet ghosts carry u = 0, D = 1)."""
    D = 1.0 + up * up
    u = up[1:-1, 1:-1]
    Dc = D[1:-1, 1:-1]
    out = 0.0
    for nbr, Dn in (
        (up[2:, 1:-1], D[2:, 1:-1]),
        (up[:-2, 1:-1], D[:-2, 1:-1]),
        (up[1:-1, 2:], D[1:-1, 2:]),
        (up[1:-1, :-2], D[1:-1, :-2]),
    ):
        out = out + 0.5 * (Dc + Dn) * (nbr - u)
    return out


def default_config(n: int = N_DEFAULT, amp: float = AMP_DEFAULT,
                   dtype=torch.float64, device=None) -> Params:
    """Params with the manufactured forcing b = −L_h(u*) in ``dtype``; in
    float64 the root is exact."""
    dx = 1.0 / (n + 1)
    us = manufactured_solution(n, amp, dtype, device)
    return Params(dx=dx, b=-_operator_scaled(pad_dirichlet(us)))


def initial_guess(n: int = N_DEFAULT, dtype=torch.float64, device=None):
    """Zero start (detuned from the manufactured root)."""
    return torch.zeros((n, n), dtype=dtype, device=device or default_device())


def residual_scaled(u, p: Params):
    """Δx²-scaled residual L_h(u) + b; root at the manufactured u*."""
    return residual_scaled_padded(pad_dirichlet(u), p)


def residual_scaled_padded(up, p: Params):
    """Residual core on a pre-padded block (one ghost ring)."""
    return _operator_scaled(up) + p.b.to(up.dtype)


def residual_scaled_df(u: dd.DF, p: Params) -> dd.DF:
    """The Δx²-scaled residual in df32 arithmetic (``u`` a DF pair): face
    diffusivities and flux differences in double-word multiplies and
    two-sum chains, the forcing an f64-split DF constant."""
    up = dd.df_map(pad_dirichlet, u)
    D = dd.add_f32(dd.mul(up, up), 1.0)  # 1 + u² on the padded block
    uc = dd.shift(up, 0, 0)
    Dc = dd.shift(D, 0, 0)
    out = None
    for off in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        face = dd.scale_pow2(dd.add(Dc, dd.shift(D, *off)), 0.5)
        term = dd.mul(face, dd.sub(dd.shift(up, *off), uc))
        out = term if out is None else dd.add(out, term)
    if p.b.dtype == torch.float64:
        b_df = dd.df_from_f64(p.b)
    else:
        b_df = dd.DF(p.b, torch.zeros_like(p.b))
    return dd.add(out, b_df)

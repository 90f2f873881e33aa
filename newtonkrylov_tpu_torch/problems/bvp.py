"""Kelley's two-point boundary-value problem (the reference's examples/bvp.jl).

Counterpart of ``newtonkrylov_tpu/problems/bvp.py``.  The staggered state
``U`` of length 2n interleaves (v, v′) on t ∈ [0, 20], n = 801 by default:
trapezoidal collocation of ``v″ = φ(t, v, v′) = 4 t† v′ + (t v − 1) v``
with the boundary conditions ``v′(0) = 0`` and ``v(20) = 0`` as the first
and last residual rows.  The Jacobian is pentadiagonal with zero diagonals
on those rows, so the robust recipe is GMRES with the pivoted
:func:`~newtonkrylov_tpu_torch.precond.banded_lu` ``(2, 2)``; the
reference's FGMRES + nested GMRES(30) stalls (its spectrum straddles the
origin).

Entry points that create tensors take a ``dtype`` (float64 by default) and
a ``device`` (by default the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import df32 as dd
from ..utils import default_device

__all__ = ["Params", "default_config", "phi", "residual", "residual_df",
           "initial_guess", "N_DEFAULT"]

N_DEFAULT = 801
T_MAX = 20.0


class Params(NamedTuple):
    tv: torch.Tensor     # collocation times, shape (n,)
    tvdag: torch.Tensor  # t† = 1/t with t†(0) = 0
    h: float             # mesh width
    n: int


def default_config(n: int = N_DEFAULT, dtype=torch.float64, device=None) -> Params:
    h = T_MAX / (n - 1)
    tv = torch.arange(n, dtype=dtype, device=device or default_device()) * h
    tvdag = torch.cat([tv.new_zeros(1), 1.0 / tv[1:]])
    return Params(tv=tv, tvdag=tvdag, h=h, n=n)


def phi(t, tdag, vp, v):
    """φ(t, v, v′)."""
    return 4.0 * tdag * vp + (t * v - 1.0) * v


def initial_guess(p: Params):
    """v₀ = e^{−0.1t²}, v′₀ = −0.2 t v₀, interleaved."""
    v = torch.exp(-0.1 * p.tv * p.tv)
    vp = -0.2 * v * p.tv
    return torch.stack([v, vp], dim=1).reshape(-1)


def _assemble(vp0, vlast, dv, dvp):
    """The residual rows in the reference's order: v′₀, then (dv′ᵢ, dvᵢ)
    for i = 1 … n−1, then v_{n−1}."""
    return torch.cat([vp0, torch.stack([dvp, dv], dim=1).reshape(-1), vlast])


def residual(U, p: Params):
    """Trapezoidal collocation residual (rows 0-based):

    * ``res[0] = v′₀`` and ``res[2n−1] = v_{n−1}`` (the boundary conditions);
    * ``res[2i] = v_i − v_{i−1} − h/2 (v′_{i−1} + v′_i)``, i = 1 … n−1;
    * ``res[2i−1] = v′_i − v′_{i−1} + h/2 (φ_{i−1} + φ_i)``, i = 1 … n−1.
    """
    v = U[0::2]
    vp = U[1::2]
    force = phi(p.tv, p.tvdag, vp, v)
    h2 = 0.5 * p.h
    dv = v[1:] - v[:-1] - h2 * (vp[:-1] + vp[1:])
    dvp = vp[1:] - vp[:-1] + h2 * (force[:-1] + force[1:])
    return _assemble(vp[:1], v[-1:], dv, dvp)


def residual_df(U: dd.DF, p: Params) -> dd.DF:
    """The collocation residual in df32 arithmetic (``U`` a DF pair): the
    times enter as f64-split DF constants, φ in double-word multiplies, the
    trapezoidal differences in exact two-sum chains; the row interleave is
    placement, exact on each word."""
    v = dd.df_map(lambda x: x[0::2], U)
    vp = dd.df_map(lambda x: x[1::2], U)
    t = dd.df_from_f64(p.tv)
    tdag = dd.df_from_f64(p.tvdag)

    # φ = 4·t†·v′ + (t·v − 1)·v
    force = dd.add(
        dd.scale_pow2(dd.mul(tdag, vp), 4.0),
        dd.mul(dd.add_f32(dd.mul(t, v), -1.0), v),
    )
    h2 = 0.5 * float(p.h)

    def first(a):
        return dd.df_map(lambda x: x[:-1], a)

    def rest(a):
        return dd.df_map(lambda x: x[1:], a)

    dv = dd.sub(dd.sub(rest(v), first(v)),
                dd.scale_const(dd.add(first(vp), rest(vp)), h2))
    dvp = dd.add(dd.sub(rest(vp), first(vp)),
                 dd.scale_const(dd.add(first(force), rest(force)), h2))
    return dd.DF(_assemble(vp.hi[:1], v.hi[-1:], dv.hi, dvp.hi),
                 _assemble(vp.lo[:1], v.lo[-1:], dv.lo, dvp.lo))

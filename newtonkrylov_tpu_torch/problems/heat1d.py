"""1-D heat equation ``uₜ = a·uₓₓ`` with Dirichlet or periodic BCs
(examples/heat_1D.jl).

Counterpart of ``newtonkrylov_tpu/problems/heat1d.py``.  The reference
enforces the BC by mutating the state inside the RHS; here a *copy* of u is
clamped (built out of place, so ``torch.func.linearize`` sees no in-place
write to the primal), the interior stencil computed and the boundary rows
of du set to zero.  Initial conditions must be pre-clamped
(:func:`clamp_bc`).

Default scenario (examples/heat_1D.jl:99-121): L=1, M=100 interior points,
a=0.2, Δt=0.1 to t=3, u₀ = f(x) = 4x(1−x).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import df32 as dd
from ..utils import default_device

__all__ = ["Params", "default_config", "rhs", "rhs_df", "clamp_bc",
           "initial_condition", "grid"]


class Params(NamedTuple):
    a: float
    dx: float
    bc: str  # "dirichlet" | "periodic"


def default_config(m: int = 100, a: float = 0.2, bc: str = "dirichlet") -> Params:
    return Params(a=a, dx=1.0 / (m + 1), bc=bc)


def grid(m: int = 100, L: float = 1.0, dtype=torch.float64, device=None):
    """xs = 0:Δx:L inclusive (examples/heat_1D.jl:100-101): m+2 points, on
    ``device`` (by default the card)."""
    dx = 1.0 / (m + 1)
    return torch.arange(0.0, L + dx / 2, dx, dtype=dtype,
                        device=device or default_device())


def initial_condition(x):
    """f(x) = 4x(1−x) (examples/heat_1D.jl:46)."""
    return 4.0 * x * (1.0 - x)


def _apply_bc(u, bc: str):
    if bc == "dirichlet":
        # bc!: u[1] = 0; u[end] = 0 (examples/heat_1D.jl:34-37)
        zero = u.new_zeros(1)
        return torch.cat([zero, u[1:-1], zero])
    if bc == "periodic":
        # periodic_bc!: u[1] = u[end-1]; u[end] = u[2] (examples/heat_1D.jl:39-42)
        return torch.cat([u[-2:-1], u[1:-1], u[1:2]])
    raise ValueError(f"unknown bc {bc!r}")


def clamp_bc(u0, p: Params):
    """Pre-apply the BC to an initial state."""
    return _apply_bc(u0, p.bc)


def _embed(interior):
    """The interior between two zero boundary rows."""
    zero = interior.new_zeros(1)
    return torch.cat([zero, interior, zero])


def rhs(u, p: Params, t=None):
    """du = a·uₓₓ on the interior, du = 0 at both boundary rows
    (examples/heat_1D.jl:14-27)."""
    ub = _apply_bc(u, p.bc)
    return _embed(p.a * (ub[2:] - 2.0 * ub[1:-1] + ub[:-2]) / (p.dx * p.dx))


def rhs_df(u, p: Params, t=None):
    """df32 RHS (``u`` a DF pair): the BC clamp is a placement (exact per
    word), the second difference runs in exact two-sum chains, and a/Δx²
    enters as a split constant."""
    ub = dd.df_map(lambda w: _apply_bc(w, p.bc), u)
    s = dd.add(dd.df_map(lambda w: w[2:], ub), dd.df_map(lambda w: w[:-2], ub))
    s = dd.add(s, dd.scale_pow2(dd.df_map(lambda w: w[1:-1], ub), -2.0))
    interior = dd.scale_const(s, float(p.a) / (float(p.dx) * float(p.dx)))
    return dd.df_map(_embed, interior)

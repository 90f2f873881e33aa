"""2-D Bratu problem ``Δu + λeᵘ = 0`` on the unit square, zero Dirichlet BCs.

Counterpart of ``newtonkrylov_tpu/problems/bratu2d.py``.  The state is the
(n, n) interior; ghosts are materialized by a constant pad.  The Δx²-scaled
residual is the flagship's (f32-safe; same roots and Newton counts).

Two layouts of the same residual:

* :func:`residual_scaled` on the plain (n, n) interior (the flagship), with
  :func:`residual_scaled_df` its df32 acceptance residual;
* :func:`residual_scaled_aligned` on the aligned ghost layout of
  :mod:`~newtonkrylov_tpu_torch.kernels.stencil2d`, whose forward runs the
  residual kernel (K2) and whose JVP runs the stencil-JVP kernel (K1).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import df32 as dd
from ..kernels import stencil2d as k
from ..ops.stencil import laplacian_2d, pad_dirichlet
from ..spaces import MaskedSpace
from ..utils import default_device

__all__ = [
    "Params",
    "default_config",
    "residual",
    "residual_scaled",
    "residual_scaled_df",
    "residual_scaled_df_padded",
    "residual_scaled_aligned",
    "aligned_setup",
    "initial_guess",
    "grid",
]

N_DEFAULT = 256
LAMBDA_DEFAULT = 6.0


class Params(NamedTuple):
    dx: float
    lam: float


def default_config(n: int = N_DEFAULT, lam: float = LAMBDA_DEFAULT) -> Params:
    return Params(dx=1.0 / (n + 1), lam=lam)


def grid(n: int = N_DEFAULT, dtype=torch.float64, device=None):
    """(X, Y) interior coordinates, ``indexing="ij"``, on ``device`` (by
    default the card)."""
    dx = 1.0 / (n + 1)
    x = torch.from_numpy(np.linspace(dx, 1.0 - dx, n)).to(
        device=device or default_device(), dtype=dtype)
    return torch.meshgrid(x, x, indexing="ij")


def initial_guess(n: int = N_DEFAULT, dtype=torch.float64, device=None):
    """sin-bump u₀ = sin(πx)sin(πy)."""
    X, Y = grid(n, dtype, device)
    return torch.sin(math.pi * X) * torch.sin(math.pi * Y)


def residual(u, p: Params):
    """Δu + λeᵘ over the interior, zero Dirichlet ghosts."""
    return laplacian_2d(pad_dirichlet(u), p.dx, p.dx) + p.lam * torch.exp(u)


def residual_scaled(u, p: Params):
    """Δx²-scaled form: (sum of neighbors − 4u) + Δx²λeᵘ."""
    up = pad_dirichlet(u)
    stencil = up[2:, 1:-1] + up[:-2, 1:-1] + up[1:-1, 2:] + up[1:-1, :-2] - 4.0 * u
    return stencil + (p.dx * p.dx) * p.lam * torch.exp(u)


def residual_scaled_df(u: dd.DF, p: Params) -> dd.DF:
    """Δx²-scaled residual in df32 arithmetic: ``hi`` is the residual to f32
    *relative* accuracy (the neighbors − 4u cancellation runs in two-sum
    chains)."""
    return residual_scaled_df_padded(
        dd.DF(pad_dirichlet(u.hi), pad_dirichlet(u.lo)), u, p)


def residual_scaled_df_padded(up: dd.DF, u: dd.DF, p: Params) -> dd.DF:
    """df32 residual core on a pre-padded (n+2, m+2) DF block ``up``; ``u``
    is the unpadded interior.  −4u is an exact power-of-two scale and Δx²λ
    enters eᵘ through an exponent shift (:func:`~df32.scaled_exp`).  One
    call of K7 (:func:`~newtonkrylov_tpu_torch.kernels.stencil2d.bratu_residual_df`):
    a kernel launch on the card, the eager df32 chain on the CPU."""
    c = float(p.dx) * float(p.dx) * float(p.lam)
    return dd.DF(*k.bratu_residual_df(up.hi, up.lo, u.hi, u.lo, c))


class _AlignedResidual(torch.autograd.Function):
    """Bratu residual on the aligned layout with a kernel-backed JVP.

    ``forward`` runs K2; ``jvp`` freezes ``w = scale·eᵘ·mask`` (zero on the
    ghosts, as K1 requires) and runs K1 — the JAX package's ``custom_jvp``.
    """

    @staticmethod
    def forward(u, n, scale):
        return k.bratu_residual(u, n, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, n, scale = inputs
        ctx.save_for_forward(u)
        ctx.n, ctx.scale = n, scale

    @staticmethod
    def jvp(ctx, v, _n, _scale):
        (u,) = ctx.saved_tensors
        w = ctx.scale * torch.exp(u) * k.aligned_mask(ctx.n, u.dtype, u.device)
        return k.stencil_jvp(v, w, ctx.n)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the aligned Bratu residual has no adjoint (J.rmv, cgls, "
            "cond2_estimate): its JVP is the K1 kernel, which has no "
            "transpose; the JAX package's rmv fails on this residual too "
            "(ROADMAP.md Queue 3 item 15). Use residual_scaled on the plain "
            "layout")


def residual_scaled_aligned(u, p: Params):
    """Δx²-scaled residual on the aligned ghost layout (see
    kernels/stencil2d.py).  State is the (n+8, round_up(n+2, 128)) ghost
    array; pair with ``MaskedSpace(aligned_mask(n))``."""
    n = u.shape[0] - 8
    return _AlignedResidual.apply(u, n, p.dx * p.dx * p.lam)


def aligned_setup(n: int = N_DEFAULT, lam: float = LAMBDA_DEFAULT,
                  dtype=torch.float32, device=None):
    """(u0_aligned, params, space) for the kernel path, on ``device`` (by
    default the card); the MaskedSpace restricts every solver reduction to
    the interior."""
    device = device or default_device()
    p = default_config(n, lam)
    u0 = k.aligned_wrap(initial_guess(n, dtype, device))
    space = MaskedSpace(k.aligned_mask(n, dtype, device))
    return u0, p, space

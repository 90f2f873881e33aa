"""Geometric multigrid and coefficient probing for 5-point-stencil Jacobians.

Counterpart of ``newtonkrylov_tpu/mg.py``.  Two operator models:

* **constant off-diagonal** ``A u = o·S(u) + d(x)·u`` — ``S`` the sum of the
  four neighbours (zero-Dirichlet ghosts), ``o`` a scalar, ``d`` a field;
  probed by :func:`probe_5point` and preconditioned by :func:`multigrid2d`,
  a V(ν,ν) cycle with damped-Jacobi smoothing, 2×2 block-mean restriction
  and nearest injection (the mass part of ``d`` restricts, ``o`` and the
  Laplacian part rescale by 1/4 per level);
* **general 5-point** ``(A v)ᵢⱼ = a0·vᵢⱼ + aip·vᵢ₊₁ⱼ + aim·vᵢ₋₁ⱼ + ajp·vᵢⱼ₊₁
  + ajm·vᵢⱼ₋₁`` with every coefficient a field (convection–diffusion,
  quasilinear diffusion) — probed by :func:`probe_5point_general` and
  preconditioned by :func:`multigrid2d_general`, a V-cycle on per-level
  rediscretizations by physical parts with ADI line smoothing
  (:func:`~newtonkrylov_tpu_torch.precond._adi_build`).

:func:`transfer_matmul` is the bilinear prolongation / full-weighting pair
as dense matrix products, which ``precond.two_grid`` uses.

Sharded forms (``axis_names=(ax0, ax1)``, one mesh axis or None per array
dimension, inside a sharded solve of :mod:`~newtonkrylov_tpu_torch.halo`):
each rank cycles its own block with zero-Dirichlet walls at the shard seams
— block-MG and block-MG-ADI, additive Schwarz with no communication per
apply.  Only the probe is mesh-aware: :func:`block_offsets` keeps its
colouring globally consistent.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .ops.stencil import pad_dirichlet
from .utils import default_device
from .utils import distributed as _dist

__all__ = ["multigrid2d", "multigrid2d_general", "vcycle", "probe_5point",
           "probe_5point_general", "transfer_matmul", "block_offsets"]


def block_offsets(shape_local, ax0, ax1):
    """Global (row, col) origin of this rank's block: ``axis_index ×
    local side`` per sharded dimension, 0 for an unsharded one.  Every
    probing factory threads these into its colouring so the colours stay
    globally consistent across the shard seams."""
    nl, ml = shape_local
    roff = _dist.axis_index(ax0) * nl if ax0 is not None else 0
    coff = _dist.axis_index(ax1) * ml if ax1 is not None else 0
    return roff, coff


def _probe_offsets(J, axis_names):
    """The probe's offsets for a factory: the block's origin when sharded."""
    if axis_names is None:
        return 0, 0
    ax0, ax1 = axis_names
    return block_offsets(J.u.shape, ax0, ax1)


def _neighbor_sum(u):
    """S(u): sum of the 4 neighbors with zero-Dirichlet ghosts."""
    up = pad_dirichlet(u)
    return up[2:, 1:-1] + up[:-2, 1:-1] + up[1:-1, 2:] + up[1:-1, :-2]


def _apply(u, o, d):
    return o * _neighbor_sum(u) + d * u


def _restrict(r):
    """Cell-centered full-weighting: 2×2 block mean (sum × 0.25); a trailing
    odd row or column is dropped, as the JAX package's VALID window does."""
    n, m = r.shape
    r = r[: n - n % 2, : m - m % 2]
    return 0.25 * r.reshape(n // 2, 2, m // 2, 2).sum(dim=(1, 3))


def _prolong(e):
    """Nearest-neighbor 2×2 injection."""
    nc, mc = e.shape
    return e[:, None, :, None].expand(nc, 2, mc, 2).reshape(2 * nc, 2 * mc)


def _prolong_bilinear(e):
    """Cell-centered bilinear prolongation (9-3-3-1 stencil, zero ghosts):
    each fine cell is the bilinear interpolant of its 4 nearest coarse cell
    centers, coarse values outside the domain zero."""
    ep = pad_dirichlet(e)
    c = ep[1:-1, 1:-1]
    up, down = ep[:-2, 1:-1], ep[2:, 1:-1]
    left, right = ep[1:-1, :-2], ep[1:-1, 2:]
    ul, ur = ep[:-2, :-2], ep[:-2, 2:]
    dl, dr = ep[2:, :-2], ep[2:, 2:]
    f00 = 9.0 * c + 3.0 * (up + left) + ul
    f01 = 9.0 * c + 3.0 * (up + right) + ur
    f10 = 9.0 * c + 3.0 * (down + left) + dl
    f11 = 9.0 * c + 3.0 * (down + right) + dr
    nc, mc = c.shape
    quad = torch.stack([torch.stack([f00, f01], dim=-1),
                        torch.stack([f10, f11], dim=-1)], dim=1)  # (nc, 2, mc, 2)
    return quad.reshape(2 * nc, 2 * mc) * (1.0 / 16.0)


def _restrict_fw(r):
    """Full-weighting restriction R = Pᵀ/4, the exact linear transpose of
    :func:`_prolong_bilinear` (``torch.func.vjp`` at a zero primal), so
    P ∝ Rᵀ holds to rounding and a two-grid cycle built from the pair is
    symmetric."""
    n, m = r.shape
    zero = r.new_zeros((n // 2, m // 2))
    _, transpose = torch.func.vjp(_prolong_bilinear, zero)
    return transpose(r)[0] * 0.25


def _p1(n: int, dtype, device=None):
    """The 1-D cell-centered bilinear prolongation matrix P₁ (n × n/2):
    fine(2i) = (3c[i] + c[i−1])/4, fine(2i+1) = (3c[i] + c[i+1])/4, coarse
    ghosts zero.  ⊗-squared it is :func:`_prolong_bilinear`'s stencil."""
    device = device or default_device()
    rows = torch.arange(n, device=device)[:, None]
    cols = torch.arange(n // 2, device=device)[None, :]
    half = rows // 2
    side = torch.where(rows % 2 == 0, half - 1, half + 1)
    return ((cols == half) * 0.75 + (cols == side) * 0.25).to(dtype)


def transfer_matmul(n: int, m: int, dtype, precision=None, device=None):
    """(P, R) bilinear transfer pair as separable matrix products:
    P e = P₁ e P₁ᵀ and R r = (P₁ᵀ r P₁)/4, the weights of
    :func:`_prolong_bilinear` / :func:`_restrict_fw`.

    ``precision`` is the JAX package's knob for its TPU matrix-unit passes;
    here every product is a full float32 ``torch.matmul`` whatever it says,
    and building the pair raises while TF32 is allowed (ROADMAP.md Queue 3
    hazard (a)), so P = 4Rᵀ holds to rounding."""
    from .fftprec import _check_matmul_precision

    _check_matmul_precision()
    Pr, Pc = _p1(n, dtype, device), _p1(m, dtype, device)
    PrT, PcT = Pr.T.contiguous(), Pc.T.contiguous()

    def P(e):
        return torch.matmul(torch.matmul(Pr, e), PcT)

    def R(r):
        return 0.25 * torch.matmul(torch.matmul(PrT, r), Pc)

    return P, R


def _levels_cap(shape, min_coarse: int) -> int:
    """Deepest hierarchy the grid supports: both sides stay even at every
    coarsening and the coarse side stays ≥ ``min_coarse``."""
    n, m = shape
    cap = 1
    while (n % 2 == 0 and m % 2 == 0
           and n // 2 >= min_coarse and m // 2 >= min_coarse):
        n //= 2
        m //= 2
        cap += 1
    return cap


def _jacobi(u, b, o, d, omega, sweeps):
    safe_d = torch.where(d != 0, d, torch.ones_like(d))
    for _ in range(sweeps):
        r = b - _apply(u, o, d)
        u = u + omega * r / safe_d
    return u


class _Level(NamedTuple):
    o: torch.Tensor
    d: torch.Tensor


def _build_levels(o, d, n_levels):
    """Coarse hierarchy: d = -4o + m splits into Laplacian + mass parts;
    o and the Laplacian part rescale by 1/4 per level, m restricts."""
    o = torch.as_tensor(o, dtype=d.dtype, device=d.device)
    levels = [_Level(o=o, d=d)]
    m = d + 4.0 * o
    for _ in range(n_levels - 1):
        o = o * 0.25
        m = _restrict(m)
        d = -4.0 * o + m
        levels.append(_Level(o=o, d=d))
    return levels


def vcycle(b, levels, level=0, *, omega=0.8, nu=2, coarse_sweeps=20):
    """One V(ν,ν) cycle for A e = b starting from e = 0."""
    o, d = levels[level]
    if level == len(levels) - 1:
        return _jacobi(torch.zeros_like(b), b, o, d, omega, coarse_sweeps)
    u = _jacobi(torch.zeros_like(b), b, o, d, omega, nu)
    r = b - _apply(u, o, d)
    ec = vcycle(_restrict(r), levels, level + 1, omega=omega, nu=nu,
                coarse_sweeps=coarse_sweeps)
    u = u + _prolong(ec)
    return _jacobi(u, b, o, d, omega, nu)


def probe_5point(J, row_offset=0, col_offset=0):
    """Extract (o, d) of a 5-point + diagonal operator by colored probing.

    One JVP with a single basis vector gives the off-diagonal coefficient;
    five JVPs with a (i + 2j) mod 5 coloring give the full diagonal field
    (no two entries of the 5-point stencil share a color under it).  The
    offsets give the global origin of a block, so the colouring of a shard
    stays globally consistent.
    """
    u = J.u
    n, m = u.shape
    dtype, device = u.dtype, u.device

    e = torch.zeros((n, m), dtype=dtype, device=device)
    e[n // 2, m // 2] = 1.0
    rows = torch.arange(n, device=device)[:, None] + row_offset
    cols = torch.arange(m, device=device)[None, :] + col_offset
    color = (rows + 2 * cols) % 5
    probes = torch.stack([e] + [(color == c).to(dtype) for c in range(5)])
    outs = J.mm(probes)  # (6, n, m)
    o = outs[0, n // 2 + 1, m // 2]  # neighbor entry = off-diagonal coefficient
    zero = torch.zeros((), dtype=outs.dtype, device=device)
    d = sum(torch.where(color == c, outs[1 + c], zero) for c in range(5))
    return o, d


def probe_5point_general(J, row_offset=0, col_offset=0):
    """Extract all five coefficient fields ``(a0, aip, aim, ajp, ajm)`` of a
    variable-coefficient 5-point operator by mod-3 colored probing.

    Three stripes ``row ≡ c (mod 3)`` isolate, at each point, the i±1
    couplings and the row-local sum ``a0 + ajp + ajm``; three column stripes
    do the transpose.  The six probes go through one ``J.mm``; the fields
    are recovered by masked select-sums.  Couplings that would reach outside
    the grid come back exactly zero.  The offsets give a block's global
    origin, as in :func:`probe_5point`.
    """
    u = J.u
    n, m = u.shape
    dtype, device = u.dtype, u.device

    rm = (torch.arange(n, device=device)[:, None] + row_offset) % 3
    cm = (torch.arange(m, device=device)[None, :] + col_offset) % 3
    rm, cm = rm.expand(n, m), cm.expand(n, m)
    probes = torch.stack([(rm == c).to(dtype) for c in range(3)]
                         + [(cm == c).to(dtype) for c in range(3)])
    outs = J.mm(probes)  # (6, n, m)
    zero = torch.zeros((), dtype=outs.dtype, device=device)

    def sel(block, idx):
        return sum(torch.where(idx == c, block[c], zero) for c in range(3))

    x0 = sel(outs[0:3], rm)             # a0 + ajp + ajm
    aip = sel(outs[0:3], (rm + 1) % 3)  # row r+1 ≡ c ⇒ probe hits the i+1 slot
    aim = sel(outs[0:3], (rm + 2) % 3)
    y0 = sel(outs[3:6], cm)             # a0 + aip + aim
    ajp = sel(outs[3:6], (cm + 1) % 3)
    ajm = sel(outs[3:6], (cm + 2) % 3)
    a0 = 0.5 * (x0 + y0 - aip - aim - ajp - ajm)
    return a0, aip, aim, ajp, ajm


def multigrid2d(
    n_levels: int | None = None,
    *,
    omega: float = 0.8,
    nu: int = 2,
    cycles: int = 1,
    coarse_sweeps: int = 20,
    min_coarse: int = 8,
    axis_names=None,
) -> Callable:
    """Preconditioner factory: J ↦ (r ↦ V-cycle(s) approximating A⁻¹r).

    Invoked at every Newton iteration (or once, ``precond_refresh="once"``)
    so the hierarchy tracks the linearization point.  Symmetric cycles: use
    with ``algo="cg"`` or FGMRES.  The hierarchy is ``n_levels`` deep, at
    most what :func:`_levels_cap` allows on the block.

    ``axis_names=(ax0, ax1)`` runs it as block-MG in a sharded solve: each
    rank V-cycles its own block, zero communication per apply, with the
    Schwarz iteration-count penalty the tests record.
    """

    def factory(J):
        o, d = probe_5point(J, *_probe_offsets(J, axis_names))
        cap = _levels_cap(d.shape, min_coarse)
        L = cap if n_levels is None else min(n_levels, cap)
        levels = _build_levels(o, d, L)

        def apply(r):
            e = vcycle(r, levels, omega=omega, nu=nu, coarse_sweeps=coarse_sweeps)
            for _ in range(cycles - 1):
                rr = r - _apply(e, levels[0].o, levels[0].d)
                e = e + vcycle(rr, levels, omega=omega, nu=nu,
                               coarse_sweeps=coarse_sweeps)
            return e

        return apply

    return factory


# ---------------------------------------------------------------------------
# Variable-coefficient multigrid: general 5-point operator, ADI line smoothing
# ---------------------------------------------------------------------------


def _apply_general(z, coeffs):
    """(A z) for the general 5-point operator of :func:`probe_5point_general`
    with zero-Dirichlet ghosts."""
    a0, aip, aim, ajp, ajm = coeffs
    zp = pad_dirichlet(z)
    return (a0 * z + aip * zp[2:, 1:-1] + aim * zp[:-2, 1:-1]
            + ajp * zp[1:-1, 2:] + ajm * zp[1:-1, :-2])


def _coarsen_general(coeffs):
    """One 2× coarsening of the five coefficient fields, by physical parts of
    the Δx²-scaled stencil:

    * symmetric off-diagonal part s = (a₊ + a₋)/2 (diffusion, h-invariant):
      restricted 2×2 mean;
    * antisymmetric part t = (a₊ − a₋)/2 (convection, ∝ h): mean × 2;
    * row sum m = a0 + Σa (reaction/mass, ∝ h²): mean × 4.

    Then the upwind clamp: each direction's symmetric part grows in
    magnitude to at least |t|, along that direction's own orientation (the
    sign of its mean; only where that mean is exactly zero, the mirror of
    the diagonal's), so every coarse operator stays diagonally dominant.
    """
    a0, aip, aim, ajp, ajm = coeffs
    si = _restrict(0.5 * (aip + aim))
    ti = 2.0 * _restrict(0.5 * (aip - aim))
    sj = _restrict(0.5 * (ajp + ajm))
    tj = 2.0 * _restrict(0.5 * (ajp - ajm))
    m = 4.0 * _restrict(a0 + aip + aim + ajp + ajm)

    one = torch.ones((), dtype=a0.dtype, device=a0.device)

    def _sgn(s):
        ms = torch.mean(s)
        fallback = torch.where(torch.mean(a0) < 0, one, -one)
        return torch.where(ms != 0, torch.sign(ms), fallback)

    sgn_i, sgn_j = _sgn(si), _sgn(sj)
    si = sgn_i * torch.maximum(sgn_i * si, torch.abs(ti))
    sj = sgn_j * torch.maximum(sgn_j * sj, torch.abs(tj))
    aip_c, aim_c = si + ti, si - ti
    ajp_c, ajm_c = sj + tj, sj - tj
    a0_c = m - (aip_c + aim_c + ajp_c + ajm_c)
    return (a0_c, aip_c, aim_c, ajp_c, ajm_c)


def _vcycle_general(b, levels, smoothers, level, nu):
    """V(ν,ν) cycle with ADI line smoothing on each level's own
    rediscretization; the coarsest level is a deeper ADI solve.  The
    residual restricts with ×4 (matching :func:`_coarsen_general`'s
    h-scaling); the correction prolongs by nearest injection."""
    coeffs = levels[level]
    S = smoothers[level]
    if level == len(levels) - 1:
        return S(b)
    z = S(b)
    for _ in range(nu - 1):
        z = z + S(b - _apply_general(z, coeffs))
    r = b - _apply_general(z, coeffs)
    ec = _vcycle_general(4.0 * _restrict(r), levels, smoothers, level + 1, nu)
    z = z + _prolong(ec)
    for _ in range(nu):
        z = z + S(b - _apply_general(z, coeffs))
    return z


def multigrid2d_general(
    n_levels: int | None = None,
    *,
    nu: int = 2,
    smoother_sweeps: int = 2,
    smooth_frac: float = 0.05,
    coarse_sweeps: int = 4,
    cycles: int = 1,
    min_coarse: int = 8,
    engine: str = "auto",
    bounds=None,
    axis_names=None,
) -> Callable:
    """Factory: variable-coefficient geometric multigrid with ADI (line)
    smoothing, for operators :func:`multigrid2d` cannot represent
    (convection-dominated transport, quasilinear diffusion).

    * probe: :func:`probe_5point_general`, six JVPs in one ``J.mm``;
    * hierarchy: per-level rediscretization by physical parts
      (:func:`_coarsen_general`);
    * smoother: Peaceman–Rachford ADI built per level from that level's
      fields with ``smoother_sweeps`` cycles on the oscillatory interval
      ``[smooth_frac·β, β]``;
    * coarse solve: ``coarse_sweeps`` ADI cycles on the coarsest level.

    ``engine`` is the tridiagonal solver of every ADI half-step, as in
    :func:`~newtonkrylov_tpu_torch.precond.adi` (``"auto"``: Thomas on a
    CPU state, PCR on a CUDA state).  ``bounds=(α, β)`` overrides the
    Wachspress interval only for a single-level hierarchy (L = 1).  The
    apply is nonsymmetric: use under ``algo="gmres"``/FGMRES.
    ``axis_names=(ax0, ax1)`` runs it as block-MG-ADI in a sharded solve
    (each rank its own block, zero communication per apply).
    """
    if nu < 1 or smoother_sweeps < 1 or coarse_sweeps < 1 or cycles < 1:
        raise ValueError("nu, smoother_sweeps, coarse_sweeps, cycles must be >= 1")

    from .precond import _adi_build, _check_adi_engine

    _check_adi_engine(engine)

    def factory(J):
        coeffs = probe_5point_general(J, *_probe_offsets(J, axis_names))
        cap = _levels_cap(coeffs[0].shape, min_coarse)
        L = cap if n_levels is None else min(n_levels, cap)

        levels = [coeffs]
        for _ in range(L - 1):
            levels.append(_coarsen_general(levels[-1]))
        # smoothing levels take their own oscillatory interval; a user
        # ``bounds`` describes the fine operator and applies only when the
        # fine level is also the coarsest
        smoothers = [
            _adi_build(lv, smoother_sweeps, None, engine, alpha_frac=smooth_frac)
            if i < L - 1 else
            _adi_build(lv, coarse_sweeps, bounds if i == 0 else None, engine)
            for i, lv in enumerate(levels)
        ]

        def apply(r):
            z = _vcycle_general(r, levels, smoothers, 0, nu)
            for _ in range(cycles - 1):
                rr = r - _apply_general(z, levels[0])
                z = z + _vcycle_general(rr, levels, smoothers, 0, nu)
            return z

        return apply

    return factory

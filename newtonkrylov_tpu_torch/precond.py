"""Preconditioner factories for the Newton inner solves.

Counterpart of ``newtonkrylov_tpu/precond.py``.  A factory is invoked with
the current :class:`~newtonkrylov_tpu_torch.operator.JacobianOperator`
(every outer iteration, or once at u₀ with ``precond_refresh="once"``) and
returns the apply ``r ↦ M⁻¹ r``.  Ported:

* :func:`nested_krylov` — a truncated inner Krylov solve on the same
  operator, for FGMRES;
* :func:`jacobi` and :func:`banded_direct` — the diagonal, or an exact
  tridiagonal solve, of the colored-probe banded materialization
  (:func:`~newtonkrylov_tpu_torch.operator.materialize_banded`);
* :func:`chebyshev` — a fixed polynomial in the operator, on the probed
  Gershgorin interval or a Lanczos one; on a CUDA state one launch of the
  hand-written kernel K4 per apply;
* :func:`two_grid` — Chebyshev smoothing + a half-resolution DST solve,
  bilinear transfers as matrix products;
* :func:`adi` — Peaceman–Rachford alternating line relaxation on the
  probed variable-coefficient stencil, for nonsymmetric
  (convection-dominated) operators, on the tridiagonal solvers
  :func:`thomas_solve` and :func:`pcr_solve`.

Not ported yet: the sharded forms ``axis_names=`` (ROADMAP.md Queue 1,
item 20), and the host-side ``banded_lu`` and ``ilu0`` (item 14).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import solvers
from .kernels import stencil2d as K
from .mg import _apply as _stencil_apply
from .mg import _no_sharding, probe_5point, probe_5point_general
from .operator import _flatten, _unflatten_like, materialize_banded
from .tree import tree_size

__all__ = ["nested_krylov", "jacobi", "banded_direct", "thomas_solve",
           "pcr_solve", "chebyshev", "two_grid", "adi"]


def _resolve_cheb_bounds(J, bounds, lanczos_k: int, space=None, v0=None):
    """A ``bounds`` spec as a concrete (lo, hi) pair, or None (probed
    Gershgorin).

    ``bounds="lanczos"`` runs a k-step Lanczos on the operator
    (:func:`~newtonkrylov_tpu_torch.spectral.extreme_eigs`,
    k = min(``lanczos_k``, n)) each time the factory runs.  The Ritz
    interval lies inside the spectrum, so its far-from-zero end is widened
    by 5% of its width; the near-zero end is not, since widening it could
    push the interval across the origin.  Eigenvalues beyond that end map
    to (0, 1) under λ·p(λ) and CG mops them up.
    """
    if not isinstance(bounds, str):
        return bounds
    if bounds != "lanczos":
        raise ValueError(f'unknown bounds spec {bounds!r}; use "lanczos" or (lo, hi)')
    from .spectral import extreme_eigs

    mult = space.size_multiplier() if space is not None else 1
    k = min(lanczos_k, tree_size(J.u) * mult)
    lo, hi = extreme_eigs(J, v0, k=k, space=space)
    half = 0.05 * (hi - lo)
    far_is_lo = torch.abs(lo) >= torch.abs(hi)
    return (torch.where(far_is_lo, lo - half, lo),
            torch.where(far_is_lo, hi, hi + half))


def _cheb_bounds(o, dmin, dmax, bounds, lo_frac, dtype):
    """Spectral interval [lo, hi] for A = o·S + d·I, as 0-d tensors (θ, δ).

    Default: Gershgorin (centers d, radius ≤ 4|o|), with the end nearest
    zero clamped to ``lo_frac``·(far end) so the interval never crosses the
    origin; eigenvalues left outside it toward 0 map to (0, 1) under λ·p(λ)
    and CG mops them up.  Works for PD and ND operators alike.
    """
    if bounds is not None:
        lo = torch.as_tensor(bounds[0], dtype=dtype, device=o.device)
        hi = torch.as_tensor(bounds[1], dtype=dtype, device=o.device)
    else:
        r4 = 4.0 * torch.abs(o)
        upper = dmax + r4
        lower = dmin - r4
        pd = (upper + lower) >= 0  # bulk on the positive side
        lo = torch.where(pd, torch.maximum(lower, lo_frac * upper), lower)
        hi = torch.where(pd, upper, torch.minimum(upper, lo_frac * lower))
    return _center_radius(lo, hi)


def _center_radius(lo, hi):
    """(θ, δ) of the interval [lo, hi], δ kept positive for a degenerate
    interval (constant-coefficient 1×1 corner cases)."""
    theta = 0.5 * (lo + hi)
    delta = 0.5 * (hi - lo)
    delta = torch.where(delta > 0, delta,
                        torch.clamp_min(1e-6 * torch.abs(theta), 1e-30))
    return theta, delta


def _cheb_recurrence(matvec: Callable, theta, delta, degree: int) -> Callable:
    """x = p_degree(A)·r via the three-term Chebyshev recurrence (Saad
    Alg. 12.1; :func:`~newtonkrylov_tpu_torch.kernels.stencil2d.chebyshev_apply_xla`
    is the fused form)."""
    sigma1 = theta / delta

    def apply(r):
        d = r / theta
        x, rvec, rho = d, r, 1.0 / sigma1
        for _ in range(degree):
            rvec = rvec - matvec(d)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * rvec
            x = x + d
            rho = rho_new
        return x

    return apply


def chebyshev(degree: int = 16, *, bounds=None, lo_frac: float = 1.0 / 30.0,
              engine: str = "auto", axis_names=None, bc: str = "dirichlet",
              lanczos_k: int = 48) -> Callable:
    """Factory: Chebyshev polynomial preconditioner M⁻¹ = p_degree(A) ≈ A⁻¹.

    A *fixed* polynomial in the operator, so it is linear and symmetric and
    runs under plain CG; its apply is ``degree`` back-to-back stencil
    matvecs with no reductions between them.  Applies to 5-point-stencil
    Jacobians ``A = o·S + d(x)·I`` on 2-D states, probed per factory call
    (:func:`~newtonkrylov_tpu_torch.mg.probe_5point`).

    ``bounds=(lo, hi)`` overrides the probed-Gershgorin interval (whose end
    nearest zero is clamped to ``lo_frac`` times the far end), and
    ``bounds="lanczos"`` measures it: ``lanczos_k`` matvecs of a Lanczos run
    each time the factory runs (see :func:`_resolve_cheb_bounds`).
    ``engine``:

    * ``"pallas"`` — the fused hand-written kernel K4
      (:func:`~newtonkrylov_tpu_torch.kernels.stencil2d.chebyshev_apply`):
      all ``degree`` applies in one launch on the aligned layout (the name
      is the JAX package's; on a CPU tensor it runs the kernel's plain
      version);
    * ``"xla"`` — the plain recurrence over PyTorch ops;
    * ``"auto"`` — the kernel on a CUDA state, the recurrence on a CPU
      state.

    The kernel takes a square float32 or float64 state with n % 8 == 0 (the
    aligned layout); any other state raises ``ValueError`` under
    ``"pallas"``, and under ``"auto"`` on the card.

    ``axis_names`` is not ported yet and raises ``NotImplementedError``, as
    does ``bc`` set to anything but ``"dirichlet"``: it acts only on the
    sharded form.
    """
    if engine not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown engine {engine!r}")
    _no_sharding("Chebyshev preconditioning", axis_names)
    if bc != "dirichlet":
        raise NotImplementedError(
            "chebyshev(bc=) acts only on the sharded form, which is not "
            "ported yet (ROADMAP.md Queue 1, item 20)")

    def factory(J):
        o, d = probe_5point(J)
        b = _resolve_cheb_bounds(J, bounds, lanczos_k)
        theta, delta = _cheb_bounds(o, torch.min(d), torch.max(d), b, lo_frac,
                                    d.dtype)
        return _cheb_engine_apply(o, d, theta, delta, degree, engine)

    return factory


def _cheb_engine_apply(o, d, theta, delta, degree: int, engine: str) -> Callable:
    """Chebyshev p_degree(A) apply for A = o·S + d·I on interval (θ, δ)."""
    n, m = d.shape
    if engine == "pallas" or (engine == "auto" and d.device.type == "cuda"):
        if not (n == m and n % 8 == 0
                and d.dtype in (torch.float32, torch.float64)):
            raise ValueError(
                "chebyshev: the K4 kernel takes a square float32 or float64 "
                f"state with n % 8 == 0, got {tuple(d.shape)} {d.dtype}; "
                'engine="xla" runs the plain recurrence')
        diag_al = K.aligned_wrap(d / o)
        # [θ, δ, o] stays on the device: the kernel reads it, no host sync
        scal = torch.stack([theta, delta, o])

        def apply(r):
            x_al = K.chebyshev_apply(K.aligned_wrap(r), diag_al, scal, n, degree)
            return K.aligned_interior(x_al, n)

        return apply

    return _cheb_recurrence(lambda x: _stencil_apply(x, o, d), theta, delta, degree)


def two_grid(
    smoother_degree: int = 8,
    *,
    smoother_frac: float = 0.25,
    engine: str = "xla",
    precision: str = "highest",
    shift: str = "mean",
    smooth_bounds=None,
    transfer: str = "matmul",
) -> Callable:
    """Factory: symmetric two-grid preconditioner — Chebyshev smoothing on
    the fine grid and an exact DST Poisson solve at half resolution.  Per
    apply:

        z  = S r
        z += P · DST⁻¹ · R (r − A z)
        z += S (r − A z)

    with S = p_k(A) on the oscillatory interval [frac·λ̂, λ̂] (Gershgorin λ̂;
    ``smooth_bounds=(lo, hi)`` overrides).  Same operator model and probe as
    :func:`~newtonkrylov_tpu_torch.mg.multigrid2d`; S and A are symmetric
    and P ∝ Rᵀ, so M is symmetric and safe under CG.

    ``transfer``: ``"matmul"`` (the bilinear pair as matrix products,
    :func:`~newtonkrylov_tpu_torch.mg.transfer_matmul`), ``"bilinear"``
    (the sliced pair and its transpose) or ``"nearest"`` (injection and
    block mean).  ``engine`` is the smoother's, as in :func:`chebyshev`:
    ``"pallas"`` runs K4 (two launches per apply), ``"xla"`` the plain
    recurrence, ``"auto"`` K4 on a CUDA state.  The coarse solve is
    :func:`~newtonkrylov_tpu_torch.fftprec.dst_poisson_solver` at
    (n/2, m/2) with ``precision``.
    """
    from .fftprec import dst_poisson_solver
    from .mg import (
        _prolong, _prolong_bilinear, _restrict, _restrict_fw, transfer_matmul,
    )

    if transfer not in ("matmul", "bilinear", "nearest"):
        raise ValueError(f"unknown transfer {transfer!r}")
    if engine not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown engine {engine!r}")

    def factory(J):
        o, d = probe_5point(J)
        n, m = d.shape
        if n % 2 or m % 2:
            raise ValueError(f"two_grid needs even grid sides, got {(n, m)}")

        if transfer == "matmul":
            P, R = transfer_matmul(n, m, d.dtype, precision="high",
                                   device=d.device)
        elif transfer == "bilinear":
            P, R = _prolong_bilinear, _restrict_fw
        else:
            P, R = _prolong, _restrict

        # smoother interval: the oscillatory part of the spectrum, which
        # 2× coarsening cannot represent
        if smooth_bounds is not None:
            lo = torch.as_tensor(smooth_bounds[0], dtype=d.dtype, device=d.device)
            hi = torch.as_tensor(smooth_bounds[1], dtype=d.dtype, device=d.device)
        else:
            r4 = 4.0 * torch.abs(o)
            upper = torch.max(d) + r4
            lower = torch.min(d) - r4
            pd = (upper + lower) >= 0
            lo = torch.where(pd, smoother_frac * upper, lower)
            hi = torch.where(pd, upper, smoother_frac * lower)
        theta, delta = _center_radius(lo, hi)
        smooth = _cheb_engine_apply(o, d, theta, delta, smoother_degree, engine)

        # coarse rediscretization of the Δx²-scaled operator: d = −4o + mass,
        # the mass carries the h² scale and restricts with a 4× factor
        mass = d + 4.0 * o
        d_c = -4.0 * o + 4.0 * _restrict(mass)
        dbar_c = torch.mean(d_c) if shift == "mean" else -4.0 * o
        coarse = dst_poisson_solver(o, dbar_c, (n // 2, m // 2), d.dtype,
                                    precision=precision)

        def apply(r):
            z = smooth(r)
            r1 = r - _stencil_apply(z, o, d)
            z = z + P(coarse(R(r1)))
            r2 = r - _stencil_apply(z, o, d)
            return z + smooth(r2)

        return apply

    return factory


def nested_krylov(algo: str = "gmres", itmax: int = 5,
                  rtol: Optional[float] = None, **kw) -> Callable:
    """Factory: J ↦ (x ↦ an approximate J⁻¹x by a truncated Krylov solve of
    ``itmax`` steps).  The preconditioner changes between applies, so the
    outer solve must be FGMRES."""

    def factory(J):
        def apply(x):
            return solvers.solve(algo, J, x, itmax=itmax,
                                 restart=min(itmax, 40), rtol=rtol, **kw).x

        return apply

    return factory


def jacobi(lower: int, upper: int) -> Callable:
    """Factory: diagonal (Jacobi) scaling for a banded Jacobian, the
    diagonal recovered by colored probing (lower + upper + 1 JVPs)."""

    def factory(J):
        _, diags = materialize_banded(J, lower, upper)
        d = diags[lower]  # offset 0
        safe = torch.where(d != 0, d, torch.ones_like(d))
        unflatten = _unflatten_like(J.u)

        def apply(x):
            return unflatten(_flatten(x) / safe)

        return apply

    return factory


def banded_direct() -> Callable:
    """Factory: an exact tridiagonal solve on the banded materialization
    (3 JVPs), the complete factorization the reference's ILU approximates
    for 1-D stencil Jacobians.

    The solver follows the state's device: :func:`pcr_solve` on a CUDA
    state, where Thomas would be n dependent steps of launches, and
    :func:`thomas_solve` (the JAX package's) on the CPU.
    """

    def factory(J):
        _, (sub, d, sup) = materialize_banded(J, 1, 1)  # offsets -1, 0, +1
        unflatten = _unflatten_like(J.u)
        solve = pcr_solve if d.device.type == "cuda" else thomas_solve

        def apply(b):
            return unflatten(solve(sub, d, sup, _flatten(b)))

        return apply

    return factory


def _systems_first(axis: int, arrays):
    """The arrays with the system index on axis 0 (a transposed view for
    ``axis=1``)."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    return tuple(x.T for x in arrays) if axis == 1 else tuple(arrays)


def thomas_solve(dl, d, du, b, axis: int = 0):
    """Tridiagonal solve by the Thomas algorithm.

    ``dl[i] = A[i, i-1]`` (dl[0] unused), ``d[i] = A[i, i]``,
    ``du[i] = A[i, i+1]`` (du[-1] unused), along ``axis`` of 1-D or 2-D
    arrays: a 2-D call solves one system per line of the other axis, all of
    them in each step of the sweep (n sequential steps of whole-batch
    elementwise ops, forward then back).
    """
    dl, d, du, b = _systems_first(axis if d.ndim == 2 else 0, (dl, d, du, b))
    n = d.shape[0]
    zero = torch.zeros_like(d[0])
    # forward sweep: c'_i = du_i / (d_i - dl_i c'_{i-1}),
    #                g_i  = (b_i - dl_i g_{i-1}) / (d_i - dl_i c'_{i-1})
    cps, gs = [], []
    cp, g = zero, zero
    for i in range(n):
        dli = dl[i] if i > 0 else zero
        denom = d[i] - dli * cp
        cp = du[i] / denom
        g = (b[i] - dli * g) / denom
        cps.append(cp)
        gs.append(g)
    # back substitution: x_i = g_i - c'_i x_{i+1}
    xs = [None] * n
    x = zero
    for i in range(n - 1, -1, -1):
        x = gs[i] - cps[i] * x
        xs[i] = x
    out = torch.stack(xs)
    return out.T if (axis == 1 and out.ndim == 2) else out


def pcr_solve(dl, d, du, b, axis: int = 0):
    """Batched tridiagonal solve by parallel cyclic reduction.

    ⌈log₂ n⌉ steps, each elementwise over the whole (n, batch) block; step k
    eliminates the couplings at stride k:

        α = −dl/d₍ᵢ₋ₖ₎,  γ = −du/d₍ᵢ₊ₖ₎
        d ← d + α·du₍ᵢ₋ₖ₎ + γ·dl₍ᵢ₊ₖ₎,  b ← b + α·b₍ᵢ₋ₖ₎ + γ·b₍ᵢ₊ₖ₎
        dl ← α·dl₍ᵢ₋ₖ₎,  du ← γ·du₍ᵢ₊ₖ₎

    with out-of-range neighbours read as identity rows (d = 1, the rest 0);
    then x = b/d.  About 3× Thomas's operations, in log₂ n steps instead of
    n.  Stable for the diagonally dominant systems ADI produces.  Conventions
    as :func:`thomas_solve`: 1-D arrays are one system, 2-D arrays are
    solved along ``axis``.
    """
    single = d.ndim == 1
    if single:
        dl, d, du, b = (x[:, None] for x in (dl, d, du, b))
        axis = 0
    dl, d, du, b = _systems_first(axis, (dl, d, du, b))
    n = d.shape[0]
    # boundary semantics: dl[0] / du[-1] are unused couplings
    dl = F.pad(dl[1:], (0, 0, 1, 0))
    du = F.pad(du[:-1], (0, 0, 0, 1))

    def down(x, k, fill):  # value at row i−k
        return F.pad(x, (0, 0, k, 0), value=fill)[:n]

    def up(x, k, fill):  # value at row i+k
        return F.pad(x, (0, 0, 0, k), value=fill)[k:]

    k = 1
    while k < n:
        alpha = -dl / down(d, k, 1.0)
        gamma = -du / up(d, k, 1.0)
        d = d + alpha * down(du, k, 0.0) + gamma * up(dl, k, 0.0)
        b = b + alpha * down(b, k, 0.0) + gamma * up(b, k, 0.0)
        dl = alpha * down(dl, k, 0.0)
        du = gamma * up(du, k, 0.0)
        k *= 2
    x = b / d
    if axis == 1:
        x = x.T
    return x[:, 0] if single else x


_ADI_ENGINES = ("auto", "thomas", "pcr")


def _check_adi_engine(engine: str) -> None:
    if engine not in _ADI_ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use one of {_ADI_ENGINES}")


def _adi_build(coeffs, sweeps: int, bounds, engine: str = "auto",
               alpha_frac=None):
    """ADI apply from probed 5-point coefficient fields (see :func:`adi`).

    ``alpha_frac`` (exclusive with ``bounds``) clamps the Wachspress
    interval's low end to ``alpha_frac·β`` instead of the smallest line
    mode: the smoother configuration of
    :func:`~newtonkrylov_tpu_torch.mg.multigrid2d_general`.  Every scalar is
    a 0-d tensor of the probe's dtype on its device: an apply reads nothing
    back to the host.

    ``engine``: ``"thomas"``, ``"pcr"``, or ``"auto"`` — Thomas on a CPU
    state (the JAX package's choice off the TPU), PCR on a CUDA state, where
    Thomas would be n dependent launches per half-step.
    """
    a0, aip, aim, ajp, ajm = coeffs
    n, m = a0.shape
    dtype, device = a0.dtype, a0.device
    scalar = dict(dtype=dtype, device=device)
    one = torch.ones((), **scalar)

    # solve the sign-flipped ("positive") system s·A z = s·r
    s = torch.where(torch.mean(a0) < 0, -one, one)
    b0, bip, bim, bjp, bjm = (s * c for c in coeffs)
    hd = 0.5 * b0
    vd = 0.5 * b0

    if bounds is not None:
        alpha = torch.as_tensor(bounds[0], **scalar)
        beta = torch.as_tensor(bounds[1], **scalar)
    else:
        beta_h = torch.max(hd + torch.abs(bip) + torch.abs(bim))
        beta_v = torch.max(vd + torch.abs(bjp) + torch.abs(bjm))
        beta = torch.maximum(beta_h, beta_v)
        if alpha_frac is not None:
            alpha = beta * torch.as_tensor(alpha_frac, **scalar)
        else:
            N = max(n, m)
            # the smallest line mode of the half-Laplacian, rounded to the
            # probe dtype before the multiply (an f64 factor would promote
            # every Krylov vector of an f32 solve)
            alpha = beta * torch.as_tensor(
                float(np.sin(np.pi / (2.0 * (N + 1))) ** 2), **scalar)
    # Wachspress cycle: geometric points of [α, β] at the exponents
    # (2j+1)/(2·sweeps), descending from β toward α
    ratio = alpha / beta
    rhos = [beta * ratio ** ((2 * j + 1) / (2.0 * sweeps))
            for j in range(sweeps)]

    def Hmul(z):
        zp = F.pad(z, (0, 0, 1, 1))
        return bim * zp[:-2, :] + hd * z + bip * zp[2:, :]

    def Vmul(z):
        zp = F.pad(z, (1, 1))
        return bjm * zp[:, :-2] + vd * z + bjp * zp[:, 2:]

    use_pcr = engine == "pcr" or (engine == "auto" and device.type == "cuda")
    solve = pcr_solve if use_pcr else thomas_solve

    def apply(r):
        f = s * r
        z = torch.zeros_like(f)
        for rho in rhos:
            z = solve(bim, hd + rho, bip, f + rho * z - Vmul(z), axis=0)
            z = solve(bjm, vd + rho, bjp, f + rho * z - Hmul(z), axis=1)
        return z

    return apply


def adi(sweeps: int = 4, *, bounds=None, axis_names=None,
        engine: str = "auto") -> Callable:
    """Factory: ADI (Peaceman–Rachford alternating-direction) preconditioner
    for general — including nonsymmetric — 5-point operators on 2-D states:
    the on-device preconditioner for the convection-dominated regime, where
    the DST-Poisson preconditioner breaks (at c ≳ 6 its preconditioned
    spectrum straddles the origin).

    The probed operator (:func:`~newtonkrylov_tpu_torch.mg.probe_5point_general`,
    six JVPs) splits as A = H + V, H tridiagonal along axis 0 and V along
    axis 1, convection terms included.  One sweep with parameter ρ:

        (H + ρI) z* = r + (ρI − V) z
        (V + ρI) z  = r + (ρI − H) z*

    Each half-step is a batch of independent tridiagonal systems
    (``engine``: see :func:`_adi_build`).  ``sweeps`` cycles take the
    Wachspress parameters on [α, β] — β from directional Gershgorin,
    α = β·sin²(π/(2(N+1))); ``bounds=(α, β)`` overrides.  With a fixed
    parameter sequence the map r ↦ z is linear but not symmetric: use it
    under GMRES.  The operator is sign-normalized internally, so positive
    and negative definite stencils both work.
    """
    if sweeps < 1:
        raise ValueError("adi needs sweeps >= 1")
    _check_adi_engine(engine)
    _no_sharding("ADI preconditioning", axis_names)

    def factory(J):
        return _adi_build(probe_5point_general(J), sweeps, bounds, engine)

    return factory

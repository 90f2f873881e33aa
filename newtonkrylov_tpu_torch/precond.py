"""Preconditioner factories for the Newton inner solves: the Chebyshev subset.

Counterpart of the part of ``newtonkrylov_tpu/precond.py`` that builds
:func:`chebyshev`.  A factory is invoked with the current
:class:`~newtonkrylov_tpu_torch.operator.JacobianOperator` (every outer
iteration, or once at u₀ with ``precond_refresh="once"``) and returns the
apply ``r ↦ M⁻¹ r``.

Not ported yet: ``bounds="lanczos"`` (needs ``spectral.py``, ROADMAP.md
Queue 1 item 19), the sharded form ``axis_names=`` (item 20), and the other
factories of the JAX module — ``nested_krylov``, ``jacobi``,
``banded_direct``, ``banded_lu``, ``ilu0``, ``thomas_solve``, ``pcr_solve``,
``two_grid``, ``adi`` (item 14).
"""

from __future__ import annotations

from typing import Callable

import torch

from .kernels import stencil2d as K
from .mg import _apply as _stencil_apply
from .mg import probe_5point

__all__ = ["chebyshev"]


def _resolve_cheb_bounds(bounds):
    """A ``bounds`` spec as a concrete (lo, hi) pair or None (probed
    Gershgorin)."""
    if not isinstance(bounds, str):
        return bounds
    if bounds != "lanczos":
        raise ValueError(f'unknown bounds spec {bounds!r}; use "lanczos" or (lo, hi)')
    raise NotImplementedError(
        'chebyshev(bounds="lanczos") needs spectral.py, which is not ported '
        "yet (ROADMAP.md Queue 1, item 19)")


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
    theta = 0.5 * (lo + hi)
    delta = 0.5 * (hi - lo)
    # degenerate interval (constant-coefficient 1×1 corner cases)
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
    nearest zero is clamped to ``lo_frac`` times the far end).  ``engine``:

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

    ``bounds="lanczos"`` and ``axis_names`` are not ported yet and raise
    ``NotImplementedError``, as do ``bc`` and ``lanczos_k`` set to anything
    but their defaults: they only act on those two paths.
    """
    if engine not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown engine {engine!r}")
    if axis_names is not None:
        raise NotImplementedError(
            "sharded Chebyshev preconditioning (axis_names=) is not ported "
            "yet (ROADMAP.md Queue 1, item 20)")
    if bc != "dirichlet" or lanczos_k != 48:
        raise NotImplementedError(
            "chebyshev(bc=, lanczos_k=) act only on the Lanczos bounds and "
            "the sharded form, which are not ported yet (ROADMAP.md Queue 1, "
            "items 19 and 20)")

    def factory(J):
        o, d = probe_5point(J)
        b = _resolve_cheb_bounds(bounds)
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

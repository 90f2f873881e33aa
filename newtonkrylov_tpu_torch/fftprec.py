"""Fast-Poisson (DST) preconditioner for 5-point-stencil Jacobians.

Counterpart of ``newtonkrylov_tpu/fftprec.py`` with ``scope="local"``.  It
diagonalizes the constant-coefficient part of ``A = o·S + d(x)·I`` exactly:
with zero-Dirichlet BCs the 5-point Laplacian's eigenvectors are the 2-D
discrete sine basis, so

    M⁻¹ r = DST₂D⁻¹[ DST₂D(r) / λ ],
    λ_{ij} = o·(2cos(iπ/(n+1)) + 2cos(jπ/(n+1))) + d̄,

with ``d̄`` the mean diagonal.  Up to ``_MATMUL_MAX_N`` one apply is four
sine-basis matrix products (``torch.matmul``) and an eigenvalue scale; above
it, odd-extension FFTs.

Precision: the JAX package's ``"high"`` is the TPU's three-pass bf16 mode
(~21 bits) and ``"highest"`` its six-pass f32 mode.  Here both are a full
float32 product.  A TF32 product keeps ~10 bits, and the JAX package
measured a preconditioner of that accuracy going from 9 to 49 inner
iterations at 1024², so the matrix-product engine refuses to build while
``torch.backends.cuda.matmul.allow_tf32`` is set.  The single-pass
``"default"`` mode is not ported.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch

from .mg import probe_5point
from .utils import default_device

__all__ = ["dst1", "idst1", "fft_poisson", "dst_poisson_solver", "sine_basis"]

# Engine crossover kept at the JAX package's value for parity; it was set on
# a TPU and is to be re-measured on the GPU (ROADMAP.md).
_MATMUL_MAX_N = 4096


def _check_matmul_precision():
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the DST preconditioner needs full float32 matrix products; "
            "set torch.backends.cuda.matmul.allow_tf32 = False (TF32 keeps "
            "~10 mantissa bits, which degrades the preconditioner)")


def dst_poisson_solver(o, dbar, shape, dtype, method: str = "auto",
                       precision: str = "highest"):
    """Exact solver for (o·S + d̄·I) x = r on an (n, m) zero-Dirichlet grid.

    ``o`` and ``dbar`` are 0-d tensors; the eigenvalues are formed in f64
    and the transforms run in ``dtype`` on ``o``'s device.  Returns
    ``apply(r)``.
    """
    if precision not in ("high", "highest"):
        raise NotImplementedError(
            f"precision {precision!r} is not ported (only full-f32 'high'/"
            "'highest'; ROADMAP.md Queue 3 hazard (a))")
    n, m = shape
    device = o.device
    f64 = dict(dtype=torch.float64, device=device)
    ci = 2.0 * torch.cos(math.pi * torch.arange(1, n + 1, **f64) / (n + 1))
    cj = 2.0 * torch.cos(math.pi * torch.arange(1, m + 1, **f64) / (m + 1))
    lam = o * (ci[:, None] + cj[None, :] - 4.0) + (dbar + 4.0 * o)
    safe = torch.where(lam.abs() > 1e-30, lam, torch.ones_like(lam))

    use_matmul = method == "matmul" or (
        method == "auto" and max(n, m) <= _MATMUL_MAX_N)
    if use_matmul:
        _check_matmul_precision()
        norm = (2.0 / (n + 1)) * (2.0 / (m + 1))
        Sr0 = sine_basis(n, dtype, device)
        Sc0 = sine_basis(m, dtype, device)
        consts = {}  # per operand dtype: (Sr, Sc, 1/λ-table, norm)

        def apply(r):
            c = consts.get(r.dtype)
            if c is None:
                c = consts[r.dtype] = (
                    Sr0.to(r.dtype), Sc0.to(r.dtype), safe.to(r.dtype),
                    torch.tensor(norm, dtype=r.dtype, device=device))
            Sr, Sc, lam_r, norm_r = c
            rh = torch.matmul(torch.matmul(Sr, r), Sc)
            rh = rh / lam_r
            out = torch.matmul(torch.matmul(Sr, rh), Sc)
            return out * norm_r

    else:

        def apply(r):
            return _idst2(_dst2(r) / safe.to(r.dtype))

    return apply


def dst1(x, axis: int = -1):
    """DST-I along ``axis`` via the odd extension + FFT.

    S_k = Σ_j x_j sin(π(j+1)(k+1)/(n+1)),  k = 0..n-1.
    """
    n = x.shape[axis]
    x = torch.movedim(x, axis, -1)
    z = x.new_zeros(x.shape[:-1] + (2 * n + 2,))
    z[..., 1:n + 1] = x
    z[..., n + 2:] = -torch.flip(x, (-1,))
    X = torch.fft.fft(z, dim=-1)
    out = -0.5 * X.imag[..., 1:n + 1]
    return torch.movedim(out.to(x.dtype), -1, axis)


def idst1(x, axis: int = -1):
    """Inverse DST-I (DST-I is self-inverse up to 2/(n+1))."""
    n = x.shape[axis]
    return dst1(x, axis) * (2.0 / (n + 1))


def _dst2(x):
    return dst1(dst1(x, 0), 1)


def _idst2(x):
    return idst1(idst1(x, 0), 1)


@functools.lru_cache(maxsize=8)
def _sine_basis_np(n: int):
    # Host-side f64 construction with exact integer argument reduction:
    # sin(π k j/(n+1)) depends only on (k·j) mod 2(n+1), so the f64 argument
    # never exceeds 2π and the table is accurate to the target dtype's eps.
    idx = np.arange(1, n + 1, dtype=np.int64)
    phase = (idx[:, None] * idx[None, :]) % (2 * (n + 1))
    out = np.sin(np.pi * phase.astype(np.float64) / (n + 1))
    out.setflags(write=False)  # shared by every caller through the cache
    return out


def sine_basis(n: int, dtype=torch.float32, device=None):
    """Symmetric DST-I basis matrix S, S_{kj} = sin(π(k+1)(j+1)/(n+1)).

    S = Sᵀ and S·S = (n+1)/2·I, so the inverse transform is S scaled by
    2/(n+1).  Built on the host in f64, then rounded to ``dtype`` once, on
    ``device`` (by default the card).
    """
    return torch.tensor(_sine_basis_np(n), dtype=dtype,
                        device=device or default_device())


def fft_poisson(shift: str = "mean", method: str = "auto",
                precision: str = "highest", axis_names=None,
                scope: str = "local") -> Callable:
    """Preconditioner factory: exact DST inverse of o·S + d̄·I.

    ``shift``: ``"mean"`` (default) absorbs the mean diagonal d̄ into the
    eigenvalues, ``"none"`` inverts the pure Laplacian part.  ``method``:
    ``"matmul"``, ``"fft"`` or ``"auto"`` (matmul up to ``_MATMUL_MAX_N``).
    The sharded forms (``axis_names``, ``scope="global"``) are not ported
    yet (ROADMAP.md Queue 1, item 20).

    Returns ``factory(J) -> apply``; ``J`` is a
    :class:`~newtonkrylov_tpu_torch.operator.JacobianOperator` on an (n, m)
    state.
    """
    if method not in ("auto", "matmul", "fft"):
        raise ValueError(f"unknown method {method!r}")
    if precision not in ("default", "high", "highest"):
        raise ValueError(f"unknown precision {precision!r}")
    if scope not in ("local", "global"):
        raise ValueError(f"unknown scope {scope!r}")
    if axis_names is not None or scope == "global":
        raise NotImplementedError(
            "sharded DST preconditioning is not ported yet "
            "(ROADMAP.md Queue 1, item 20)")

    def factory(J):
        o, d = probe_5point(J)
        n, m = d.shape
        dbar = torch.mean(d) if shift == "mean" else -4.0 * o
        return dst_poisson_solver(o, dbar, (n, m), d.dtype, method, precision)

    return factory

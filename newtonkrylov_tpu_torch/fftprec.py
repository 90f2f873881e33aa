"""Fast-Poisson (DST) preconditioner for 5-point-stencil Jacobians.

Counterpart of ``newtonkrylov_tpu/fftprec.py``.  It diagonalizes the
constant-coefficient part of ``A = o·S + d(x)·I`` exactly: with
zero-Dirichlet BCs the 5-point Laplacian's eigenvectors are the 2-D discrete
sine basis, so

    M⁻¹ r = DST₂D⁻¹[ DST₂D(r) / λ ],
    λ_{ij} = o·(2cos(iπ/(n+1)) + 2cos(jπ/(n+1))) + d̄,

with ``d̄`` the mean diagonal.  Up to ``_MATMUL_MAX_N`` one apply is four
sine-basis matrix products (``torch.matmul``) and an eigenvalue scale; above
it, odd-extension FFTs.

Precision, as the JAX package names it:

* ``"high"`` (the TPU's three-pass bf16 mode, ~21 bits) and ``"highest"``
  (its six-pass f32 mode) are both a full float32 product here.  A TF32
  product keeps ~10 bits, so these modes refuse to build while
  ``torch.backends.cuda.matmul.allow_tf32`` is set.
* ``"default"`` is the single-pass mode: each of the four products rounds
  both operands (the basis, once at build, and the intermediate, every
  product) to bfloat16 and accumulates in float32.  On a CUDA float32
  state that is the bf16 tensor-core product with an f32 result
  (``torch.mm(..., out_dtype=torch.float32)``); on the CPU the rounded
  operands are multiplied in float32 (a product of two bf16 numbers is
  exact in f32, so only the summation order differs from the card; the
  JAX package's CPU ignores the precision, ROADMAP.md Queue 3 item 27); a
  float64 state rounds its operands to bf16 and accumulates in float64.
  The eigenvalue scale and the normalization stay in the state's dtype.

The FFT engine ignores the precision.

Sharded (``axis_names=``, inside a solve of :mod:`~newtonkrylov_tpu_torch.halo`):
``scope="local"`` solves each rank's block alone (block Jacobi, no
communication per apply); ``scope="global"`` is the global inverse as four
distributed sine-basis products per apply, each a local product and one
``reduce_scatter`` over a mesh axis (:func:`_dist_dst_axis0`,
:func:`_dist_dst_axis1`).
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch

from .exportable import exporting
from .mg import _probe_offsets, probe_5point
from .utils import default_device
from .utils import distributed as _dist

__all__ = ["dst1", "idst1", "fft_poisson", "dst_poisson_solver", "sine_basis"]

# Engine crossover kept at the JAX package's value for parity; it was set on
# a TPU and is to be re-measured on the GPU (ROADMAP.md).
_MATMUL_MAX_N = 4096
_PRECISIONS = ("default", "high", "highest")


def _check_matmul_precision():
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the DST preconditioner needs full float32 matrix products; "
            "set torch.backends.cuda.matmul.allow_tf32 = False (TF32 keeps "
            "~10 mantissa bits, which degrades the preconditioner)")


def _products(precision: str, dtype, device):
    """``(rnd, mm)`` for the sine-basis products of one apply: ``rnd``
    rounds an operand as ``precision`` asks (the identity for the full
    f32 modes, bf16 for ``"default"``) and ``mm(a, b)`` multiplies two
    rounded operands into ``dtype``."""
    if precision != "default":
        return (lambda x: x), torch.matmul
    bf16 = torch.bfloat16
    if torch.device(device).type == "cuda" and dtype == torch.float32:
        # cuBLAS's bf16 tensor-core product, accumulated and returned in f32
        return ((lambda x: x.to(bf16)),
                (lambda a, b: torch.mm(a, b, out_dtype=torch.float32)))
    return (lambda x: x.to(bf16).to(dtype)), torch.mm


def dst_poisson_solver(o, dbar, shape, dtype, method: str = "auto",
                       precision: str = "highest"):
    """Exact solver for (o·S + d̄·I) x = r on an (n, m) zero-Dirichlet grid.

    ``o`` and ``dbar`` are 0-d tensors; the eigenvalues are formed in f64
    and the transforms run in ``dtype`` on ``o``'s device.  ``precision``
    is that of the matrix-product engine (the module's notes).  Returns
    ``apply(r)``.
    """
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
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
        if precision != "default":  # the single pass is bf16, not TF32
            _check_matmul_precision()
        norm = (2.0 / (n + 1)) * (2.0 / (m + 1))
        Sr0 = sine_basis(n, dtype, device)
        Sc0 = sine_basis(m, dtype, device)
        consts = {}  # per operand dtype: (rnd, mm, Sr, Sc, 1/λ-table, norm)

        def constants(dt):
            rnd, mm = _products(precision, dt, device)
            return (rnd, mm, rnd(Sr0.to(dt)), rnd(Sc0.to(dt)), safe.to(dt),
                    torch.tensor(norm, dtype=dt, device=device))

        # made here for the solver's dtype: an exported solve applies the
        # preconditioner inside its loops, where a new constant cannot be
        # serialized and a cache may not be filled
        consts[dtype] = constants(dtype)

        def apply(r):
            c = consts.get(r.dtype)
            if c is None:
                c = constants(r.dtype)
                if not exporting():  # a traced constant stays out
                    consts[r.dtype] = c
            rnd, mm, Sr, Sc, lam_r, norm_r = c
            rh = mm(rnd(mm(Sr, rnd(r))), Sc)
            rh = rh / lam_r
            out = mm(rnd(mm(Sr, rnd(rh))), Sc)
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


def _dist_dst_axis0(r, S_cols, ax, mm=torch.matmul):
    """DST-I along global axis 0 of a block-sharded array (local block
    ``r``): the product ``mm`` of the basis' column block owned by this
    rank (``S_cols``, (n, nl)) with the local rows, then a
    ``reduce_scatter`` over mesh axis ``ax`` that hands each rank its own
    row block of the sum.  ``ax`` None (the axis unsharded): the plain
    local product with the whole basis."""
    partial = mm(S_cols, r)  # (n, ml)
    if ax is None:
        return partial
    return _dist.reduce_scatter(partial, ax)


def _dist_dst_axis1(r, S_rows, ax, mm=torch.matmul):
    """DST-I along global axis 1; mirror of :func:`_dist_dst_axis0` with the
    row block ``S_rows`` ((ml, m)).  The scatter runs on the transposed
    partial product (contiguous, dim 0), and the block comes back
    contiguous, so the next product sees the unsharded layout."""
    partial = mm(r, S_rows)  # (nl, m)
    if ax is None:
        return partial
    return _dist.reduce_scatter(partial.t().contiguous(), ax).t().contiguous()


def _global_dst_solver(o, d, offsets, axis_names, shift, precision):
    """The global (o·S + d̄·I)⁻¹ in a sharded solve: the arithmetic of
    :func:`dst_poisson_solver`'s matrix-product engine, with each of its
    four products distributed (a local product in ``precision`` and one
    reduce-scatter of its partials; no all-gather).  d̄ is the global mean
    diagonal (one all-reduce).  ``offsets`` is the block's global origin."""
    ax0, ax1 = axis_names
    nl, ml = d.shape
    roff, coff = offsets
    n = nl * (_dist.axis_size(ax0) if ax0 is not None else 1)
    m = ml * (_dist.axis_size(ax1) if ax1 is not None else 1)
    if max(n, m) > _MATMUL_MAX_N:
        raise ValueError(
            f'scope="global" inferred a global side of {max(n, m)} > '
            f"{_MATMUL_MAX_N} (= _MATMUL_MAX_N): the distributed sine-basis "
            "matmul engine is not valid at this size; use scope='local' or a "
            "Chebyshev/two-grid preconditioner")
    if precision != "default":
        _check_matmul_precision()
    names = tuple(a for a in axis_names if a is not None)
    device = o.device
    if shift == "mean":
        dbar = _dist.all_reduce(torch.sum(d), names) / (n * m)
    else:
        dbar = -4.0 * o
    f64 = dict(dtype=torch.float64, device=device)
    ci = 2.0 * torch.cos(math.pi * torch.arange(1, n + 1, **f64) / (n + 1))
    cj = 2.0 * torch.cos(math.pi * torch.arange(1, m + 1, **f64) / (m + 1))
    ci, cj = ci[roff:roff + nl], cj[coff:coff + ml]
    lam = o * (ci[:, None] + cj[None, :] - 4.0) + (dbar + 4.0 * o)
    safe = torch.where(lam.abs() > 1e-30, lam, torch.ones_like(lam))
    norm = (2.0 / (n + 1)) * (2.0 / (m + 1))
    Sr0 = sine_basis(n, d.dtype, device)
    Sc0 = Sr0 if m == n else sine_basis(m, d.dtype, device)
    consts = {}  # per operand dtype: the products, the owned basis blocks,
    # the 1/λ table and the norm

    def apply(r):
        c = consts.get(r.dtype)
        if c is None:
            rnd, mm = _products(precision, r.dtype, device)
            Sr, Sc = rnd(Sr0.to(r.dtype)), rnd(Sc0.to(r.dtype))
            c = consts[r.dtype] = (
                rnd, mm, Sr[:, roff:roff + nl].contiguous(),
                Sc[coff:coff + ml, :].contiguous(),
                safe.to(r.dtype), torch.tensor(norm, dtype=r.dtype, device=device))
        rnd, mm, S_cols, S_rows, lam_r, norm_r = c

        def transform(x):
            return _dist_dst_axis1(rnd(_dist_dst_axis0(rnd(x), S_cols, ax0, mm)),
                                   S_rows, ax1, mm)

        return transform(transform(r) / lam_r) * norm_r

    return apply


def fft_poisson(shift: str = "mean", method: str = "auto",
                precision: str = "highest", axis_names=None,
                scope: str = "local") -> Callable:
    """Preconditioner factory: exact DST inverse of o·S + d̄·I.

    ``shift``: ``"mean"`` (default) absorbs the mean diagonal d̄ into the
    eigenvalues, ``"none"`` inverts the pure Laplacian part.  ``method``:
    ``"matmul"``, ``"fft"`` or ``"auto"`` (matmul up to ``_MATMUL_MAX_N``).
    ``precision``: ``"highest"`` (default) or ``"high"``, a full float32
    product, or ``"default"``, the single-pass bf16 product with float32
    accumulation (the module's notes).

    Sharded use: ``axis_names=(ax0, ax1)`` (a mesh axis or None per array
    dimension) with ``scope`` ``"local"`` (the default: each rank inverts
    its own block with zero-Dirichlet walls at the seams — additive
    Schwarz, no communication per apply, an iteration-count penalty that
    grows with the rank count) or ``"global"`` (the global inverse, the
    single device's counts: four distributed sine-basis products per
    apply; the matrix-product engine only).  The probe's colouring follows
    the block's global origin either way.

    Returns ``factory(J) -> apply``; ``J`` is a
    :class:`~newtonkrylov_tpu_torch.operator.JacobianOperator` on an (n, m)
    state.
    """
    if method not in ("auto", "matmul", "fft"):
        raise ValueError(f"unknown method {method!r}")
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if scope not in ("local", "global"):
        raise ValueError(f"unknown scope {scope!r}")
    if scope == "global":
        if axis_names is None:
            raise ValueError('scope="global" requires axis_names')
        if method == "fft":
            raise ValueError('scope="global" supports only the matmul engine')

    def factory(J):
        offsets = _probe_offsets(J, axis_names)
        o, d = probe_5point(J, *offsets)
        if scope == "global":
            return _global_dst_solver(o, d, offsets, tuple(axis_names), shift,
                                      precision)
        n, m = d.shape
        dbar = torch.mean(d) if shift == "mean" else -4.0 * o
        return dst_poisson_solver(o, dbar, (n, m), d.dtype, method, precision)

    return factory

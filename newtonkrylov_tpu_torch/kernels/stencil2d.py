"""Fused 2-D stencil kernels on the aligned ghost layout (the JFNK hot matvec).

Counterpart of ``newtonkrylov_tpu/kernels/stencil2d.py``.  Inside the Krylov
loop every iteration applies the linearized Bratu residual

    (J v)[i,j] = v[i±1,j] + v[i,j±1] − 4 v[i,j] + w[i,j]·v[i,j]

with ``w = Δx²λeᵘ`` frozen at the linearization point.

Layout — the aligned ghost layout of the JAX package, kept for parity:

* arrays are ``(R, C)`` with ``R = n + 8`` (n % 8 == 0) and
  ``C = round_up(n + 2, 128)``;
* interior row i lives at array row i (i ∈ [0, n)); rows [n, n+8) are a zero
  bottom apron;
* interior col j lives at array col j+1; col 0 and cols [n+1, C) are zero
  ghosts.

Two single-step kernels (CUDA in ``csrc/stencil2d.cu``), each a
``torch.library.custom_op`` so that :func:`torch.func.linearize` can trace
through it:

* K1 :func:`stencil_jvp` — ``lap(v) + w·v`` (replaces ``stencil_jvp_pallas``);
* K2 :func:`bratu_residual` — ``lap(u) + scale·eᵘ`` (replaces
  ``bratu_residual_pallas``).

Three chained kernels, k dependent 5-point steps in one launch (CUDA in
``csrc/chain2d.cu``); no residual reaches them, so they are plain functions:

* K3 :func:`stencil_jvp_chain` — k steps ``x ← s·mask·(lap x + w x)``
  (replaces ``stencil_jvp_chain_pallas``);
* K4 :func:`chebyshev_apply` — the Chebyshev polynomial preconditioner's
  apply (replaces ``chebyshev_apply_pallas``);
* K5 :func:`stencil_chain_probe` — the unmasked speed-of-light probe
  (replaces ``stencil_chain_probe_pallas``).

On a CPU tensor each op runs its plain PyTorch version (the ``*_xla``
functions, which mirror the Pallas bodies operation for operation); on a
CUDA tensor it launches the CUDA kernel or raises.  ``LAUNCHES`` counts
kernel launches, and only those.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import default_device
from . import build

__all__ = [
    "round_up",
    "aligned_wrap",
    "aligned_interior",
    "aligned_mask",
    "stencil_jvp_xla",
    "bratu_residual_xla",
    "stencil_jvp_chain_xla",
    "stencil_chain_probe_xla",
    "chebyshev_apply_xla",
    "stencil_jvp",
    "bratu_residual",
    "stencil_jvp_chain",
    "stencil_chain_probe",
    "chebyshev_apply",
    "LAUNCHES",
    "reset_launch_counts",
]

LAUNCHES = {"stencil_jvp": 0, "bratu_residual": 0, "stencil_jvp_chain": 0,
            "stencil_chain_probe": 0, "chebyshev_apply": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _dims(n: int):
    if n % 8:
        raise ValueError(f"interior size must be a multiple of 8, got {n}")
    return n + 8, round_up(n + 2, 128)


def aligned_wrap(u_interior):
    """Embed an (n, n) interior into the aligned ghost layout."""
    n = u_interior.shape[0]
    R, C = _dims(n)
    out = u_interior.new_zeros((R, C))
    out[0:n, 1:n + 1] = u_interior
    return out


def aligned_interior(u, n: int):
    return u[0:n, 1:n + 1]


def aligned_mask(n: int, dtype=torch.float32, device=None):
    """0/1 interior mask for MaskedSpace reductions, on ``device`` (by
    default the card)."""
    R, C = _dims(n)
    device = device or default_device()
    rows = torch.arange(R, device=device)[:, None]
    cols = torch.arange(C, device=device)[None, :]
    return ((rows < n) & (cols >= 1) & (cols <= n)).to(dtype)


def _shifts(x):
    """(up, dn, left, right): the four neighbours by wrap-around rolls over
    the whole (R, C) array, as ``pltpu.roll`` reads them.  The zero apron
    rows wrap onto row 0 as its top ghost and row n's apron zeros serve row
    n−1."""
    return (torch.roll(x, 1, 0), torch.roll(x, -1, 0),
            torch.roll(x, 1, 1), torch.roll(x, -1, 1))


def _lap(v):
    """5-point neighbour sum − 4v."""
    up, dn, left, right = _shifts(v)
    return up + dn + left + right - 4.0 * v


def stencil_jvp_xla(v, w, n: int):
    """Plain version of K1: (lap(v) + w·v)·mask, as the JAX package's
    ``stencil_jvp_xla``."""
    return (_lap(v) + w * v) * aligned_mask(n, v.dtype, v.device)


def bratu_residual_xla(u, n: int, scale: float):
    """Plain version of K2: (lap(u) + scale·eᵘ)·mask, as the JAX package's
    ``residual_scaled_aligned`` forward."""
    return (_lap(u) + scale * torch.exp(u)) * aligned_mask(n, u.dtype, u.device)


def stencil_jvp_chain_xla(v, w, n: int, k: int, scale: float = 1.0):
    """Plain version of K3, the JAX package's ``_chain_kernel`` operation for
    operation: ``w4 = w − 4`` once; ``raw(x) = (((up + dn) + left) + right)
    + w4·x``; each double step scales as (1, s²) with ``s·s`` rounded in the
    dtype; an odd k ends with one ``raw(x)·s``; every step selects the
    interior and writes 0 elsewhere."""
    mask = aligned_mask(n, torch.bool, v.device)
    zero = v.new_zeros(())
    w4 = w - 4.0
    s = torch.tensor(scale, dtype=v.dtype, device=v.device)
    s2 = s * s

    def raw(x):
        up, dn, left, right = _shifts(x)
        return up + dn + left + right + w4 * x

    x = v.clone()
    for _ in range(k // 2):
        x = torch.where(mask, raw(x), zero)
        x = torch.where(mask, raw(x) * s2, zero)
    if k % 2:
        x = torch.where(mask, raw(x) * s, zero)
    return x


def _check_steps(name: str, what: str, k: int, even: bool = False):
    """A chained kernel's step count: ≥ 0, and even for the probe, which
    runs double steps."""
    if k < 0 or (even and k % 2):
        raise ValueError(f"{name}: {what} must be ≥ 0"
                         f"{' and even' if even else ''}, got {k}")


def stencil_chain_probe_xla(v, w, n: int, k: int):
    """Plain version of K5, the JAX package's ``_chain_probe_kernel``: k
    unmasked steps over the whole (R, C) array, ghosts and apron included,
    ``raw(x) = ((up + dn) + (left + right)) + w4·x``, each double step
    scaled by 1/64.  k must be even."""
    _check_steps("stencil_chain_probe", "k", k, even=True)
    w4 = w - 4.0
    s2 = torch.tensor(1.0 / 64.0, dtype=v.dtype, device=v.device)

    def raw(x):
        up, dn, left, right = _shifts(x)
        return ((up + dn) + (left + right)) + w4 * x

    x = v.clone()
    for _ in range(k // 2):
        x = raw(raw(x)) * s2
    return x


def chebyshev_apply_xla(r, diag, scal, n: int, degree: int):
    """Plain version of K4, the JAX package's ``_cheb_kernel``: x =
    p_degree(A)·r for ``A v = o·((((up + dn) + left) + right) + diag·v)``
    on the interior, by Saad's three-term recurrence on the interval
    given by ``scal = [θ, δ, o]``, a 3-vector of the dtype of ``r``::

        σ₁ = θ/δ, ρ = 1/σ₁, d = r·(1/θ), x = d
        degree times: r ← r − mask·A(d); ρ' = 1/(2σ₁ − ρ);
                      d ← (ρ'ρ)·d + (2ρ'/δ)·r; x ← x + d; ρ ← ρ'

    ``d₀`` multiplies by the reciprocal of θ, as the kernel does (the XLA
    engine of ``precond`` divides).
    """
    mask = aligned_mask(n, torch.bool, r.device)
    zero = r.new_zeros(())
    theta, delta, o = scal[0], scal[1], scal[2]
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    d = r * (1.0 / theta)
    x = d
    for _ in range(degree):
        up, dn, left, right = _shifts(d)
        r = r - torch.where(mask, o * (up + dn + left + right + diag * d), zero)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        x = x + d
        rho = rho_new
    return x


_C_DTYPES = {torch.float32: 0, torch.float64: 1}


def _check(name, n, *arrays):
    R, C = _dims(n)
    ref = arrays[0]
    for a in arrays:
        if a.device.type != "cuda" or a.device != ref.device:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {a.device}")
        if a.dtype not in _C_DTYPES or a.dtype != ref.dtype:
            raise ValueError(f"{name}: expected float32 or float64 tensors "
                             f"of one dtype, got {a.dtype}")
        if tuple(a.shape) != (R, C):
            raise ValueError(f"{name}: expected shape {(R, C)} (aligned_wrap "
                             f"layout of n={n}), got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    return R, C


_VP, _INT, _DBL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# nk_<kernel>: (source in csrc/, argument types).  Every function takes its
# array pointers, then R, C, n, its scalars, is_double and the stream, and
# returns the cudaError_t of the launch.
_SIGNATURES = {
    "stencil_jvp": ("stencil2d", [_VP] * 3 + [_INT] * 3 + [_INT, _VP]),
    "bratu_residual": ("stencil2d", [_VP] * 2 + [_INT] * 3 + [_DBL, _INT, _VP]),
    "stencil_jvp_chain": ("chain2d", [_VP] * 4 + [_INT] * 3
                          + [_INT, _DBL, _INT, _VP]),
    "stencil_chain_probe": ("chain2d", [_VP] * 4 + [_INT] * 3
                            + [_INT, _INT, _VP]),
    "chebyshev_apply": ("chain2d", [_VP] * 7 + [_INT] * 3
                        + [_INT, _INT, _VP]),
}
_BOUND: dict = {}


def _kernel(name: str):
    fn = _BOUND.get(name)
    if fn is None:
        source, argtypes = _SIGNATURES[name]
        fn = getattr(build.load(source), f"nk_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    return fn


def _launch(name: str, n: int, inputs, *scalars, extra=(), scratch=0):
    """Launch ``nk_<name>`` on the current stream of the inputs' device:
    ``(inputs..., extra..., out, scratch..., R, C, n, scalars...,
    is_double, stream)``.  ``inputs`` are layout arrays; ``extra`` are other
    device arrays of the inputs' dtype, checked by the caller."""
    R, C = _check(name, n, *inputs)
    out = torch.empty_like(inputs[0])
    work = [torch.empty_like(out) for _ in range(scratch)]
    fn = _kernel(name)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(*(a.data_ptr() for a in (*inputs, *extra, out, *work)),
                R, C, n, *scalars, _C_DTYPES[out.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError_t {rc})")
    LAUNCHES[name] += 1
    return out


def _on_cpu(t) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA tensor
    (kernel); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.device.type == "cpu"


# linearize traces with an expanded (stride-0) placeholder tangent, hence the
# .contiguous() before a launch; on a contiguous tensor it is free.
@torch.library.custom_op("newtonkrylov_tpu_torch::stencil_jvp", mutates_args=())
def stencil_jvp(v: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """K1: out = (lap(v) + w·v) on the interior, 0 on ghosts and apron."""
    if _on_cpu(v):
        return stencil_jvp_xla(v, w, n)
    return _launch("stencil_jvp", n, (v.contiguous(), w.contiguous()))


@stencil_jvp.register_fake
def _(v, w, n):
    return torch.empty_like(v)


@torch.library.custom_op("newtonkrylov_tpu_torch::bratu_residual",
                         mutates_args=())
def bratu_residual(u: torch.Tensor, n: int, scale: float) -> torch.Tensor:
    """K2: out = (lap(u) + scale·eᵘ) on the interior, 0 on ghosts and apron."""
    if _on_cpu(u):
        return bratu_residual_xla(u, n, scale)
    return _launch("bratu_residual", n, (u.contiguous(),), float(scale))


@bratu_residual.register_fake
def _(u, n, scale):
    return torch.empty_like(u)


def stencil_jvp_chain(v, w, n: int, k: int, scale: float = 1.0):
    """K3: k chained matvecs ``x ← scale·(J x)`` from ``x = v`` in one
    launch (see :func:`stencil_jvp_chain_xla` for the exact arithmetic).
    ``v`` and ``w`` are aligned-layout arrays; ``v`` is not modified."""
    _check_steps("stencil_jvp_chain", "k", k)
    if _on_cpu(v):
        return stencil_jvp_chain_xla(v, w, n, k, scale)
    return _launch("stencil_jvp_chain", n, (v, w), int(k), float(scale),
                   scratch=1)


def stencil_chain_probe(v, w, n: int, k: int):
    """K5: k unmasked probe steps in one launch (see
    :func:`stencil_chain_probe_xla`); k must be even."""
    if _on_cpu(v):
        return stencil_chain_probe_xla(v, w, n, k)
    _check_steps("stencil_chain_probe", "k", k, even=True)
    return _launch("stencil_chain_probe", n, (v, w), int(k), scratch=1)


def chebyshev_apply(r, diag, scal, n: int, degree: int):
    """K4: ``x = p_degree(A)·r`` in one launch (see
    :func:`chebyshev_apply_xla`).  ``r`` and ``diag`` are aligned-layout
    arrays, ``scal = [θ, δ, o]`` a device 3-vector of their dtype, read by
    the kernel itself: no host synchronisation.  ``r`` is not modified."""
    _check_steps("chebyshev_apply", "degree", degree)
    if _on_cpu(r):
        return chebyshev_apply_xla(r, diag, scal, n, degree)
    if (scal.device != r.device or scal.dtype != r.dtype
            or tuple(scal.shape) != (3,) or not scal.is_contiguous()):
        raise ValueError(f"chebyshev_apply: scal must be a contiguous (3,) "
                         f"tensor of {r.dtype} on {r.device}, got "
                         f"{tuple(scal.shape)} {scal.dtype} on {scal.device}")
    return _launch("chebyshev_apply", n, (r, diag), int(degree), extra=(scal,),
                   scratch=3)

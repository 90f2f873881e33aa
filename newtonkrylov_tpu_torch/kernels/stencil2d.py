"""Fused 2-D stencil kernels on the aligned ghost layout (the JFNK hot matvec).

Counterpart of :mod:`newtonkrylov_tpu.kernels.stencil2d`.  Inside the Krylov
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

Two kernels, each a ``torch.library.custom_op`` so that
:func:`torch.func.linearize` can trace through it:

* K1 :func:`stencil_jvp` — ``lap(v) + w·v`` (replaces ``stencil_jvp_pallas``);
* K2 :func:`bratu_residual` — ``lap(u) + scale·eᵘ`` (replaces
  ``bratu_residual_pallas``).

On a CPU tensor each op runs its plain PyTorch version
(:func:`stencil_jvp_xla`, :func:`bratu_residual_xla`); on a CUDA tensor it
launches the CUDA kernel of ``csrc/stencil2d.cu`` or raises.  ``LAUNCHES``
counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = [
    "round_up",
    "aligned_wrap",
    "aligned_interior",
    "aligned_mask",
    "stencil_jvp_xla",
    "bratu_residual_xla",
    "stencil_jvp",
    "bratu_residual",
    "LAUNCHES",
    "reset_launch_counts",
]

LAUNCHES = {"stencil_jvp": 0, "bratu_residual": 0}


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


def aligned_mask(n: int, dtype=torch.float32, device="cpu"):
    """0/1 interior mask for MaskedSpace reductions."""
    R, C = _dims(n)
    rows = torch.arange(R, device=device)[:, None]
    cols = torch.arange(C, device=device)[None, :]
    return ((rows < n) & (cols >= 1) & (cols <= n)).to(dtype)


def _lap(v):
    """5-point neighbour sum − 4v by wrap-around rolls: the zero apron rows
    wrap onto row 0 as its top ghost and row n's apron zeros serve row n−1."""
    up = torch.roll(v, 1, 0)
    dn = torch.roll(v, -1, 0)
    left = torch.roll(v, 1, 1)
    right = torch.roll(v, -1, 1)
    return up + dn + left + right - 4.0 * v


def stencil_jvp_xla(v, w, n: int):
    """Plain version of K1: (lap(v) + w·v)·mask, as the JAX package's
    ``stencil_jvp_xla``."""
    return (_lap(v) + w * v) * aligned_mask(n, v.dtype, v.device)


def bratu_residual_xla(u, n: int, scale: float):
    """Plain version of K2: (lap(u) + scale·eᵘ)·mask, as the JAX package's
    ``residual_scaled_aligned`` forward."""
    return (_lap(u) + scale * torch.exp(u)) * aligned_mask(n, u.dtype, u.device)


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


def _library() -> ctypes.CDLL:
    lib = build.load("stencil2d")
    if not getattr(lib, "_nk_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nk_stencil_jvp.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        lib.nk_stencil_jvp.restype = ci
        lib.nk_bratu_residual.argtypes = [vp, vp, ci, ci, ci,
                                          ctypes.c_double, ci, vp]
        lib.nk_bratu_residual.restype = ci
        lib._nk_bound = True
    return lib


def _launch(name: str, n: int, inputs, *scalars):
    """Launch ``nk_<name>`` on the current stream of the inputs' device:
    ``(input pointers..., out, R, C, n, scalars..., is_double, stream)``."""
    R, C = _check(name, n, *inputs)
    out = torch.empty_like(inputs[0])
    fn = getattr(_library(), f"nk_{name}")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(*(a.data_ptr() for a in inputs), out.data_ptr(), R, C, n,
                *scalars, _C_DTYPES[out.dtype], stream)
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

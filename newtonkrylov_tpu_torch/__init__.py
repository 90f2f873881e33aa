"""newtonkrylov_tpu_torch — the PyTorch/CUDA port of ``newtonkrylov_tpu``.

A Jacobian-free Newton–Krylov solver for PyTorch tensors on an NVIDIA H100
(or the CPU).  The JAX package ``newtonkrylov_tpu`` is the reference it is
held against; module names and array layouts follow it.  Ported so far: the
2-D Bratu main path — :func:`newton_krylov_jit` with GMRES/FGMRES (its
default), CG (plain and pipelined), BiCGStab and CGLS, the Eisenstat–Walker
forcing, df32 acceptance residuals, the DST-Poisson and Chebyshev
preconditioners (with Lanczos bounds), and the aligned-layout residual
whose matvec runs the hand-written CUDA stencil kernels of
:mod:`.kernels.stencil2d`, which also holds the chained kernels (the
Chebyshev apply among them); the operator's adjoint and materializers and
the spectral diagnostics (:mod:`.spectral`); the Kelley 2×2, 1-D Bratu and
convection–diffusion problems; the multigrid (:mod:`.mg`), two-grid, ADI,
Jacobi, banded-direct and nested-Krylov preconditioners; and the
chained-step cost probe of :mod:`.kernels.probe` with its measuring script
:mod:`.benchmarks.kernel_probe`.  Entry points that create tensors
do so on the card unless the caller names a device.

This package imports ``torch`` and never ``jax``.
"""

from . import df32, fftprec, kernels, mg, precond, problems, solvers, spectral
from .forcing import EisenstatWalker, Fixed, Forcing
from .newton import NewtonInfo, Stats, newton_krylov_jit
from .operator import (
    AdjointOperator,
    JacobianOperator,
    LinearOperator,
    materialize_banded,
    materialize_dense,
)
from .solvers import KrylovResult, bicgstab, cg, cgls, fgmres, gmres
from .spaces import EuclideanSpace, MaskedSpace, VectorSpace

__all__ = [
    "newton_krylov_jit",
    "NewtonInfo",
    "Stats",
    "Forcing",
    "Fixed",
    "EisenstatWalker",
    "JacobianOperator",
    "AdjointOperator",
    "LinearOperator",
    "materialize_dense",
    "materialize_banded",
    "gmres",
    "fgmres",
    "cg",
    "bicgstab",
    "cgls",
    "KrylovResult",
    "VectorSpace",
    "EuclideanSpace",
    "MaskedSpace",
    "df32",
    "fftprec",
    "kernels",
    "mg",
    "precond",
    "problems",
    "solvers",
    "spectral",
]

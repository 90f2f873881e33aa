"""newtonkrylov_tpu_torch — the PyTorch/CUDA port of ``newtonkrylov_tpu``.

A Jacobian-free Newton–Krylov solver for PyTorch tensors on an NVIDIA H100
(or the CPU).  The JAX package ``newtonkrylov_tpu`` is the reference it is
held against; module names and array layouts follow it.  Ported so far: the
2-D Bratu main path — :func:`newton_krylov_jit` with GMRES/FGMRES (its
default) and plain PCG, the Eisenstat–Walker forcing, df32 acceptance
residuals, the DST-Poisson and Chebyshev preconditioners, and the
aligned-layout residual whose matvec runs the hand-written CUDA stencil
kernels of :mod:`.kernels.stencil2d`, which also holds the chained kernels
(the Chebyshev apply among them); the convection–diffusion problem; the
multigrid (:mod:`.mg`), two-grid and ADI line-relaxation preconditioners;
and the chained-step cost probe of :mod:`.kernels.probe` with its measuring
script :mod:`.benchmarks.kernel_probe`.  Entry points that create tensors
do so on the card unless the caller names a device.

This package imports ``torch`` and never ``jax``.
"""

from . import df32, fftprec, kernels, mg, precond, problems, solvers
from .forcing import EisenstatWalker, Fixed, Forcing
from .newton import NewtonInfo, Stats, newton_krylov_jit
from .operator import JacobianOperator, LinearOperator
from .spaces import EuclideanSpace, MaskedSpace, VectorSpace

__all__ = [
    "newton_krylov_jit",
    "NewtonInfo",
    "Stats",
    "Forcing",
    "Fixed",
    "EisenstatWalker",
    "JacobianOperator",
    "LinearOperator",
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
]

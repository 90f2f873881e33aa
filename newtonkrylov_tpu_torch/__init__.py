"""newtonkrylov_tpu_torch — the PyTorch/CUDA port of ``newtonkrylov_tpu``.

A Jacobian-free Newton–Krylov solver for PyTorch tensors on an NVIDIA H100
(or the CPU).  The JAX package ``newtonkrylov_tpu`` is the reference it is
held against; module names and array layouts follow it.  Ported so far: the
reference's public driver :func:`newton_krylov` (host-stepped, with
callbacks and host-side preconditioner factories) and
:func:`newton_krylov_jit`, both with Armijo backtracking and the three
precision modes; pseudo-transient continuation (:func:`pseudo_transient`);
GMRES/FGMRES (the drivers' default), CG (plain and pipelined), BiCGStab and
CGLS, the Eisenstat–Walker forcing, df32 acceptance residuals, the
DST-Poisson and Chebyshev preconditioners (with Lanczos bounds), and the
aligned-layout residual
whose matvec runs the hand-written CUDA stencil kernels of
:mod:`.kernels.stencil2d`, which also holds the chained kernels (the
Chebyshev apply among them); the operator's adjoint and materializers and
the spectral diagnostics (:mod:`.spectral`); the Kelley 2×2, 1-D Bratu,
convection–diffusion, two-point BVP and quasilinear diffusion problems; the
multigrid (:mod:`.mg`), two-grid, ADI, Jacobi, banded-direct and
nested-Krylov preconditioners and the host-side banded LU and ILU(0) (host
C++, built with the host compiler at first use); and the
chained-step cost probe of :mod:`.kernels.probe` with its measuring script
:mod:`.benchmarks.kernel_probe`; and distribution (:mod:`.halo`): one
process per device over ``torch.distributed``, the halo exchange, the
sharded drivers (:func:`.halo.newton_krylov_sharded`,
:func:`.halo.integrate_scan_sharded`), :class:`ShardedSpace` and the
sharded preconditioners, with the bring-up in :mod:`.utils.distributed`
and a multi-device dry run in :mod:`.utils.dryrun`.  Entry points that
create tensors do so on the card unless the caller names a device.

This package imports ``torch`` and never ``jax``.
"""

from . import (df32, fftprec, halo, kernels, mg, precond, problems, solvers,
               spectral, timestep)
from .continuation import pseudo_transient
from .forcing import EisenstatWalker, Fixed, Forcing
from .implicit import make_implicit_solver
from .newton import (NewtonInfo, NewtonOptions, Stats, newton_krylov,
                     newton_krylov_jit)
from .operator import (
    AdjointOperator,
    JacobianOperator,
    LinearOperator,
    materialize_banded,
    materialize_dense,
)
from .solvers import KrylovResult, bicgstab, cg, cgls, fgmres, gmres
from .spaces import EuclideanSpace, MaskedSpace, ShardedSpace, VectorSpace
from .timestep import integrate, integrate_scan

__all__ = [
    "newton_krylov",
    "newton_krylov_jit",
    "pseudo_transient",
    "NewtonOptions",
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
    "ShardedSpace",
    "integrate",
    "integrate_scan",
    "make_implicit_solver",
    "df32",
    "fftprec",
    "halo",
    "kernels",
    "mg",
    "precond",
    "problems",
    "solvers",
    "spectral",
    "timestep",
]

"""Preconditioned Conjugate Gradient.

Counterpart of the plain PCG of :mod:`newtonkrylov_tpu.solvers.cg`: the same
recurrences, space-injected reductions and Krylov.jl termination
``‖r‖ ≤ atol + rtol·‖r₀‖``.  The loop is a Python ``while`` over device
scalars; its condition reads one boolean back per iteration, the only host
synchronisation of an iteration.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..spaces import EuclideanSpace, VectorSpace
from ..tree import tree_axpy, tree_dtype, tree_size, tree_sub, tree_zeros_like
from .common import KrylovResult, as_operator, default_tols

__all__ = ["cg"]


def cg(
    A,
    b,
    x0=None,
    *,
    itmax: Optional[int] = None,
    atol: Optional[float] = None,
    rtol=None,
    M: Optional[Callable] = None,
    space: Optional[VectorSpace] = None,
    pipeline: bool = False,
) -> KrylovResult:
    """Solve SPD (or negative-definite) A x = b with left-preconditioned CG.

    ``M`` applies the preconditioner inverse.  ``rtol`` may be a 0-d tensor
    (η from the Newton forcing).  Stops at ``‖r‖ ≤ atol + rtol·‖r₀‖`` or
    ``itmax`` (default 2n).
    """
    if pipeline:
        raise NotImplementedError(
            "pipelined CG is not ported yet (ROADMAP.md Queue 1, item 13)")
    Aop = as_operator(A)
    Mop = as_operator(M) if M is not None else None
    space = space or EuclideanSpace()

    if x0 is None:
        x0 = tree_zeros_like(b)
    atol, rtol = default_tols(tree_dtype(b), atol, rtol)
    if itmax is None:
        itmax = 2 * tree_size(b) * space.size_multiplier()

    def precond(r):
        return Mop(r) if Mop is not None else r

    x = x0
    r = space.mask_tree(tree_sub(b, Aop(x0)))
    p = precond(r)
    rz = space.dot(r, p)
    resnorm = space.norm(r)
    eps_abs = atol + rtol * resnorm
    k = 0
    converged = resnorm <= eps_abs
    breakdown = torch.zeros_like(converged)

    while k < itmax and not bool(converged | breakdown):
        # No per-iteration re-masking: operators preserve the space's mask
        # and the space's reductions are mask-weighted regardless.
        Ap = Aop(p)
        pAp = space.dot(p, Ap)
        # A negative-definite A runs CG as the sign mirror of CG on (-A, -b),
        # so only pAp == 0 is a breakdown.
        brk = pAp == 0
        alpha = rz / torch.where(brk, torch.ones_like(pAp), pAp)
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, Ap, r)
        z = precond(r)
        rr, rz_new = space.dot2(r, r, r, z)
        resnorm = torch.sqrt(rr.real)
        beta = rz_new / torch.where(rz != 0, rz, torch.ones_like(rz))
        p = tree_axpy(beta, p, z)
        rz = rz_new
        k += 1
        converged = resnorm <= eps_abs
        breakdown = breakdown | brk

    return KrylovResult(x, k, resnorm, converged, breakdown)

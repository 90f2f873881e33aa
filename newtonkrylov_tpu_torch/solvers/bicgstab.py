"""BiCGStab and CGLS.

Counterpart of ``newtonkrylov_tpu/solvers/bicgstab.py``: the reference's
``algo = :bicgstab`` and ``:cgls``, which its 1-D Bratu gallery shows
failing there, with the same recurrences, breakdown guards, space-injected
reductions and Krylov.jl termination.  Each loop is a Python ``while`` over
device scalars that reads one boolean back per iteration, as
:func:`~newtonkrylov_tpu_torch.solvers.cg.cg`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..spaces import EuclideanSpace, VectorSpace
from ..tree import tree_axpy, tree_dtype, tree_size, tree_sub, tree_zeros_like
from .common import KrylovResult, as_operator, default_tols, nonzero_or_one

__all__ = ["bicgstab", "cgls"]


def bicgstab(
    A,
    b,
    x0=None,
    *,
    itmax: Optional[int] = None,
    atol: Optional[float] = None,
    rtol=None,
    M: Optional[Callable] = None,
    N: Optional[Callable] = None,
    space: Optional[VectorSpace] = None,
) -> KrylovResult:
    """Stabilized bi-conjugate gradients for general square systems.

    ``M``/``N`` are left/right preconditioner inverses applied by
    composition: solve M·A·N y = M b and return x = N y.  A zero ⟨r̂, r⟩ or
    ⟨t, t⟩ is a breakdown and ends the solve.
    """
    Aop0 = as_operator(A)
    Mop = as_operator(M) if M is not None else None
    Nop = as_operator(N) if N is not None else None
    space = space or EuclideanSpace()

    def Aop(v):
        w = Nop(v) if Nop is not None else v
        w = Aop0(w)
        return Mop(w) if Mop is not None else w

    b_eff = Mop(b) if Mop is not None else b
    if x0 is None:
        x0 = tree_zeros_like(b)
    atol, rtol = default_tols(tree_dtype(b), atol, rtol)
    if itmax is None:
        itmax = 2 * tree_size(b) * space.size_multiplier()

    r = space.mask_tree(tree_sub(b_eff, Aop(x0)))
    rhat = r  # the shadow residual
    resnorm = space.norm(r)
    eps_abs = atol + rtol * resnorm
    one = torch.ones_like(resnorm)
    x, p, v = x0, tree_zeros_like(b), tree_zeros_like(b)
    rho = alpha = omega = one
    k = 0
    converged = resnorm <= eps_abs
    breakdown = torch.zeros_like(converged)
    while k < itmax and not bool(converged | breakdown):
        rho_new = space.dot(rhat, r)
        brk = torch.abs(rho_new) == 0
        beta = (rho_new / nonzero_or_one(rho)) * (alpha / nonzero_or_one(omega))
        p = tree_axpy(beta, tree_axpy(-omega, v, p), r)
        v = Aop(p)  # operators preserve the mask (see cg.py)
        alpha = rho_new / nonzero_or_one(space.dot(rhat, v))
        s = tree_axpy(-alpha, v, r)
        t = Aop(s)
        tt, ts = space.dot2(t, t, t, s)
        omega = ts / nonzero_or_one(tt)
        x = tree_axpy(omega, s, tree_axpy(alpha, p, x))
        r = tree_axpy(-omega, t, s)
        resnorm = space.norm(r)
        rho = rho_new
        k += 1
        converged = resnorm <= eps_abs
        breakdown = breakdown | brk | (tt == 0)
    if Nop is not None:
        x = Nop(x)
    return KrylovResult(x, k, resnorm, converged, breakdown)


def cgls(
    A,
    b,
    x0=None,
    *,
    At: Optional[Callable] = None,
    itmax: Optional[int] = None,
    atol: Optional[float] = None,
    rtol=None,
    space: Optional[VectorSpace] = None,
) -> KrylovResult:
    """CG on the normal equations AᵀA x = Aᵀb (least squares).

    ``At`` applies Aᵀ; an operator with ``rmv`` (a
    :class:`~newtonkrylov_tpu_torch.operator.JacobianOperator`) supplies it
    itself.  Stops when ‖b − Ax‖ ≤ atol + rtol·‖r₀‖.
    """
    Aop = as_operator(A)
    if At is None:
        if not hasattr(A, "rmv"):
            raise ValueError("cgls needs At= (or an operator with .rmv)")
        At = A.rmv
    space = space or EuclideanSpace()
    atol, rtol = default_tols(tree_dtype(b), atol, rtol)

    r = space.mask_tree(b if x0 is None else tree_sub(b, Aop(x0)))
    s = At(r)
    x = tree_zeros_like(s) if x0 is None else x0
    if itmax is None:
        itmax = 2 * tree_size(x) * space.size_multiplier()
    p = s
    gamma = space.dot(s, s)
    resnorm = space.norm(r)
    eps_abs = atol + rtol * resnorm
    k = 0
    converged = resnorm <= eps_abs
    while k < itmax and not bool(converged):
        q = Aop(p)
        alpha = gamma / nonzero_or_one(space.dot(q, q))
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, q, r)
        s = At(r)
        gamma_new, rr = space.dot2(s, s, r, r)
        p = tree_axpy(gamma_new / nonzero_or_one(gamma), p, s)
        gamma = gamma_new
        resnorm = torch.sqrt(rr.real)
        k += 1
        converged = resnorm <= eps_abs
    return KrylovResult(x, k, resnorm, converged, torch.zeros_like(converged))

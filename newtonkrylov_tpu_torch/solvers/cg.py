"""Preconditioned Conjugate Gradient, plain and pipelined.

Counterpart of ``newtonkrylov_tpu/solvers/cg.py``: the same recurrences,
space-injected reductions and Krylov.jl termination
``‖r‖ ≤ atol + rtol·‖r₀‖``.  Each loop is a Python ``while`` over device
scalars that reads back one boolean (pipelined: two, in one transfer) per
iteration, the only host synchronisation of an iteration.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..spaces import EuclideanSpace, VectorSpace
from ..tree import tree_axpy, tree_dtype, tree_size, tree_sub, tree_zeros_like
from .common import KrylovResult, as_operator, default_tols, nonzero_or_one

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

    ``pipeline=True`` runs the Ghysels–Vanroose pipelined recurrence
    (:func:`_cg_pipelined`): one fused reduction per iteration instead of
    two, at the price of four extra vector recurrences whose rounding drift
    costs iterations on an unpreconditioned ill-conditioned f32 system.
    """
    Aop = as_operator(A)
    Mop = as_operator(M) if M is not None else None
    space = space or EuclideanSpace()

    if x0 is None:
        x0 = tree_zeros_like(b)
    dtype = tree_dtype(b)
    atol, rtol = default_tols(dtype, atol, rtol)
    if itmax is None:
        itmax = 2 * tree_size(b) * space.size_multiplier()
    if pipeline:
        return _cg_pipelined(Aop, Mop, b, x0, itmax, atol, rtol, space, dtype)

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


def _cg_pipelined(Aop, Mop, b, x0, itmax, atol, rtol, space, dtype):
    """Pipelined PCG (Ghysels & Vanroose, Parallel Computing 40, 2014).

    Per iteration one fused reduction (``space.dot_stack``): γ = ⟨r, u⟩,
    δ = ⟨w, u⟩ and the exact ‖r‖², with u = M⁻¹r and w = Au kept by
    recurrence; the preconditioner apply ``m = M w`` and the matvec
    ``n = A m`` do not depend on it.  Convergence is tested on that exact
    norm at the top of the body, so it is seen one body after the update
    that reached it: that detection body gates its update off and does not
    count, which gives plain CG's counts.  A solve that reaches the
    tolerance at exactly ``itmax`` is caught by one exact norm after the
    loop, which also makes the returned residual the final one.
    """
    def precond(v):
        return Mop(v) if Mop is not None else v

    r = space.mask_tree(tree_sub(b, Aop(x0)))
    u = precond(r)
    w = space.mask_tree(Aop(u))
    rr0 = space.dot(r, r).real
    eps_abs = atol + rtol * torch.sqrt(rr0)
    zero = torch.zeros((), dtype=dtype, device=rr0.device)
    x = x0
    p = s = q = z = tree_zeros_like(b)
    gamma_prev = alpha_prev = torch.ones_like(zero)
    k = 0
    converged = torch.sqrt(rr0) <= eps_abs
    breakdown = torch.zeros_like(converged)
    done = bool(converged)
    while not done and k < itmax:
        gamma, delta, rr = space.dot_stack([(r, u), (w, u), (r, r)])
        rr = rr.real
        m = precond(w)
        n = space.mask_tree(Aop(m))

        conv = torch.sqrt(rr) <= eps_abs
        beta = zero if k == 0 else gamma / nonzero_or_one(gamma_prev)
        denom = delta - beta * gamma / nonzero_or_one(alpha_prev)
        brk = ~conv & (denom == 0)
        alpha = torch.where(conv | brk, zero, gamma / nonzero_or_one(denom))

        z = tree_axpy(beta, z, n)       # z = A q
        q = tree_axpy(beta, q, m)       # q = M⁻¹ s
        s = tree_axpy(beta, s, w)       # s = A p
        p = tree_axpy(beta, p, u)
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, s, r)
        u = tree_axpy(-alpha, q, u)
        w = tree_axpy(-alpha, z, w)

        gamma_prev = torch.where(conv, gamma_prev, gamma)
        alpha_prev = torch.where(conv, alpha_prev, alpha)
        converged, breakdown = conv, breakdown | brk
        conv_h, brk_h = torch.stack([conv, breakdown]).tolist()
        k += 0 if conv_h else 1
        done = conv_h or brk_h

    resnorm = torch.sqrt(space.dot(r, r).real)
    return KrylovResult(x, k, resnorm, converged | (resnorm <= eps_abs),
                        breakdown)

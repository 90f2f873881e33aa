"""Differentiable Newton–Krylov solves (implicit function theorem).

Counterpart of ``newtonkrylov_tpu/implicit.py``: the solution map
``p ↦ u*(p)`` of ``F(u, p) = 0`` as a :class:`torch.autograd.Function`, so
a solve composes with ``torch.autograd`` for PDE-constrained optimization
and sensitivity analysis.  Reverse mode uses the adjoint equation instead
of differentiating through the Newton iteration:

    dL/dp = −(∂F/∂p)ᵀ · J⁻ᵀ · dL/du       with J = ∂F/∂u at u*.

The adjoint solve ``Jᵀλ = g`` runs the matrix-free Krylov solvers on the
operator's adjoint (``JacobianOperator.T``); ``∂F/∂p`` is one
:func:`torch.func.vjp`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import solvers
from .newton import newton_krylov_jit
from .operator import JacobianOperator
from .spaces import VectorSpace
from .tree import tree_leaves, tree_map

__all__ = ["make_implicit_solver"]


def _tensor_leaves(p):
    """(the tensor leaves of ``p``, ``rebuild(leaves) -> p``): ``p`` may be
    a tensor, a tuple, a named tuple or a dict of them; non-tensor leaves
    (Python numbers, strings) stay fixed."""
    leaves = [l for l in tree_leaves(p) if isinstance(l, torch.Tensor)]

    def rebuild(new):
        it = iter(new)
        return tree_map(lambda l: next(it) if isinstance(l, torch.Tensor) else l, p)

    return leaves, rebuild


class _ImplicitSolve(torch.autograd.Function):
    """The solved root ``u*`` as a function of ``(u0, p)``: the forward
    passes the root through and the backward is the adjoint.  The solve
    itself runs before, outside the Function: ``torch.func.linearize``
    called inside a custom Function's ``forward`` returns zero tangents."""

    @staticmethod
    def forward(ctx, F, rebuild, adjoint_algo, adjoint_kwargs, u, u0, *leaves):
        ctx.F, ctx.rebuild = F, rebuild
        ctx.adjoint_algo, ctx.adjoint_kwargs = adjoint_algo, adjoint_kwargs
        ctx.save_for_backward(u, u0, *leaves)
        return u.clone()

    @staticmethod
    def backward(ctx, g):
        u, u0, *leaves = ctx.saved_tensors
        F, rebuild = ctx.F, ctx.rebuild
        with torch.enable_grad():
            J = JacobianOperator(F, u, rebuild(leaves))
            # adjoint solve Jᵀ λ = g
            lam = solvers.solve(ctx.adjoint_algo, J.T, g, **ctx.adjoint_kwargs).x
            # dp = −(∂F/∂p)ᵀ λ
            _, vjp_p = torch.func.vjp(lambda *ls: F(u, rebuild(ls)), *leaves)
            dps = vjp_p(lam)
        return (None, None, None, None, None, torch.zeros_like(u0),
                *(-d for d in dps))


def make_implicit_solver(
    F: Callable,
    *,
    adjoint_algo: str = "bicgstab",
    adjoint_kwargs: Optional[dict] = None,
    space: Optional[VectorSpace] = None,
    **newton_kwargs,
) -> Callable:
    """Build a differentiable solver ``solve(u0, p) -> u*``.

    ``newton_kwargs`` configure the forward
    :func:`~newtonkrylov_tpu_torch.newton.newton_krylov_jit` solve, run
    under ``torch.no_grad()``; ``adjoint_algo``/``adjoint_kwargs`` the linear
    adjoint solve (defaults: BiCGStab, ``rtol=1e-10``, ``atol=0``).  Pass
    ``adjoint_algo="cg"`` for symmetric Jacobians, or non-restarted GMRES
    (``adjoint_kwargs={"restart": None, "itmax": ...}``) for hard
    nonsymmetric ones; ``adjoint_kwargs["M"]`` is a preconditioner apply.

    Gradients flow to the tensor leaves of ``p`` (a tensor, tuple, named
    tuple or dict); the cotangent of ``u0`` is zero — the root does not
    depend on the initial guess.  The aligned Bratu residual has no adjoint
    (ROADMAP.md Queue 3 item 15): its backward raises
    ``NotImplementedError``.
    """
    adjoint_kwargs = dict(adjoint_kwargs or {})
    adjoint_kwargs.setdefault("rtol", 1e-10)
    adjoint_kwargs.setdefault("atol", 0.0)
    if space is not None:
        adjoint_kwargs.setdefault("space", space)
        newton_kwargs.setdefault("space", space)

    def solve(u0, p):
        leaves, rebuild = _tensor_leaves(p)
        with torch.no_grad():
            u, _info = newton_krylov_jit(
                F, u0.detach(), rebuild([l.detach() for l in leaves]),
                **newton_kwargs)
        return _ImplicitSolve.apply(F, rebuild, adjoint_algo, adjoint_kwargs,
                                    u, u0, *leaves)

    return solve

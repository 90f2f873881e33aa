"""Matrix-free spectral diagnostics: Lanczos and Arnoldi Ritz values.

Counterpart of ``newtonkrylov_tpu/spectral.py``:

* :func:`lanczos_tridiag` — k-step Lanczos on a symmetric operator, with one
  classical Gram–Schmidt projection against the whole stacked basis per
  step by default (full reorthogonalization);
* :func:`extreme_eigs` — (λ_min, λ_max) Ritz estimates from it, exact to
  rounding at k = n; ``precond.chebyshev(bounds="lanczos")`` takes its
  interval from here;
* :func:`arnoldi_hessenberg` and :func:`ritz_values` — nonsymmetric Ritz
  values from a k-step Arnoldi factorization (CGS2), the small eigenproblem
  on the host;
* :func:`cond2_estimate` — κ₂ by Lanczos on the normal operator AᵀA.

The iterations keep the JAX package's fixed-shape, masked form: the basis
is allocated once with k rows, a breakdown clears the flag ``ok`` instead
of ending the loop, and the count ``m`` of genuine steps and every scalar
stay 0-d tensors on the state's device.  A run of k steps issues its work
without reading anything back to the host; the small eigenproblem at its
end is the one read.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .operator import LinearOperator
from .spaces import EuclideanSpace, VectorSpace
from .tree import (
    tree_axpy,
    tree_basis_combine,
    tree_get_row,
    tree_map,
    tree_scale,
    tree_set_row,
    tree_stack_like,
    tree_sub,
    tree_where,
)

__all__ = [
    "FnOperator",
    "lanczos_tridiag",
    "extreme_eigs",
    "arnoldi_hessenberg",
    "ritz_values",
    "cond2_estimate",
]


class FnOperator(LinearOperator):
    """A plain linear function ``v → A v`` as an operator, with an optional
    adjoint ``rfn``: the normal operator ``v → Aᵀ(A v)`` here, and any
    ad-hoc linear map handed to the solvers or the diagnostics."""

    def __init__(self, fn: Callable, example_in: Any, rfn: Optional[Callable] = None):
        self.fn = fn
        self.rfn = rfn
        self.example_in = example_in

    def mv(self, v):
        return self.fn(v)

    def rmv(self, w):
        if self.rfn is None:
            raise NotImplementedError("FnOperator built without an adjoint")
        return self.rfn(w)

    def mm(self, V):
        return torch.stack([self.fn(v) for v in V])


def _normalize(space, v):
    nrm = space.norm(v)
    safe = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    return tree_scale(1.0 / safe, v), nrm


def _set_row_if(V, j, ok, x):
    """Row j of V becomes x where the 0-d ``ok`` holds (no host read)."""
    return tree_set_row(V, j, tree_where(ok, x, tree_get_row(V, j)))


def _default_start(example):
    """cos(0, 1, 2, …) over each leaf: broadband, so both spectral ends show."""
    return tree_map(
        lambda l: torch.cos(torch.arange(l.numel(), dtype=l.dtype,
                                         device=l.device)).reshape(l.shape),
        example)


def lanczos_tridiag(
    A,
    v0: Any,
    k: int,
    *,
    space: Optional[VectorSpace] = None,
    reorth: bool = True,
):
    """k-step Lanczos on a **symmetric** operator A.

    Returns ``(alpha, beta, V, m)``: the diagonal ``alpha`` (k,), the
    off-diagonal ``beta`` (k,) (``beta[j] = T[j+1, j]``; ``beta[k-1]`` is
    the residual coupling), the stacked orthonormal basis ``V`` (k rows)
    and ``m``, the number of genuine steps (a 0-d int tensor).  After a
    breakdown (an invariant subspace, β ≈ 0) ``m < k``: the leading (m, m)
    block of T is exact and the rows past it are zero.

    ``reorth=True`` projects each new vector against all k stacked rows
    (the rows not yet written are zero and contribute nothing).
    """
    space = space or EuclideanSpace()
    q, nrm0 = _normalize(space, v0)
    dtype, device = nrm0.dtype, nrm0.device
    scalar = dict(dtype=dtype, device=device)
    zero = torch.zeros((), **scalar)
    tiny = 10.0 * torch.finfo(dtype).eps

    V = tree_set_row(tree_stack_like(q, k), 0, q)
    alpha = torch.zeros((k,), **scalar)
    beta = torch.zeros((k,), **scalar)
    q_prev, beta_prev = tree_map(torch.zeros_like, q), zero
    m = torch.zeros((), dtype=torch.int32, device=device)
    live = torch.ones((), dtype=torch.bool, device=device)
    for j in range(k):
        w = A.mv(q)
        a = space.dot(q, w)
        w = tree_axpy(-a, q, w)
        w = tree_axpy(-beta_prev, q_prev, w)
        if reorth:
            w = tree_sub(w, tree_basis_combine(V, space.project_rows(V, w)))
        b = space.norm(w)
        ok = live & (b > tiny * torch.abs(a))
        inv = torch.where(ok, 1.0 / torch.where(b > 0, b, torch.ones_like(b)), zero)
        q_next = tree_scale(inv, w)
        if j + 1 < k:
            V = _set_row_if(V, j + 1, ok, q_next)
        alpha[j] = torch.where(live, a, zero)
        b_ok = torch.where(ok, b, zero)
        beta[j] = b_ok
        m = m + live.to(m.dtype)  # this step produced a genuine row of T
        q_prev, q, beta_prev, live = q, q_next, b_ok, ok
    return alpha, beta, V, m


def extreme_eigs(
    A,
    v0: Any = None,
    k: int = 32,
    *,
    space: Optional[VectorSpace] = None,
    reorth: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(λ_min, λ_max) Ritz estimates of a symmetric operator, 0-d tensors.

    Lanczos extremes converge first, and with k = n they are the spectrum
    to rounding.  Ritz values interlace, so at small k the interval is
    inside the true one (optimistic), and a clustered extreme (a
    Laplacian's λ_min) can be overshot by orders of magnitude.  ``v0``
    defaults to cos(0, 1, 2, …) over the operator's example input.
    """
    if v0 is None:
        v0 = _default_start(A.example_in if hasattr(A, "example_in") else A.u)
    alpha, beta, _, m = lanczos_tridiag(A, v0, k, space=space, reorth=reorth)
    T = torch.diag(alpha) + torch.diag(beta[:-1], 1) + torch.diag(beta[:-1], -1)
    # past a breakdown T has zero padding rows, whose eigenvalue 0 would
    # pollute the extremes: their diagonal takes T[0, 0], a value inside the
    # Ritz hull, before the symmetric eigensolve
    pad = torch.arange(k, device=m.device) >= m
    T = T + torch.diag(torch.where(pad, alpha[0], torch.zeros_like(alpha)))
    evals = torch.linalg.eigvalsh(T)
    return evals[0], evals[-1]


def arnoldi_hessenberg(
    A,
    v0: Any,
    k: int,
    *,
    space: Optional[VectorSpace] = None,
):
    """k-step Arnoldi factorization A V_k ≈ V_k H + h_{k+1,k} v_{k+1} e_kᵀ.

    Returns ``(H, V)``: ``H`` of shape (k+1, k) (upper Hessenberg plus the
    residual row) and ``V`` the stacked (k+1)-row orthonormal basis.  Each
    step orthogonalizes by CGS2, two projection passes against the whole
    stacked basis.
    """
    space = space or EuclideanSpace()
    q, nrm0 = _normalize(space, v0)
    dtype, device = nrm0.dtype, nrm0.device
    zero = torch.zeros((), dtype=dtype, device=device)
    tiny = 10.0 * torch.finfo(dtype).eps

    V = tree_set_row(tree_stack_like(q, k + 1), 0, q)
    H = torch.zeros((k + 1, k), dtype=dtype, device=device)
    for j in range(k):
        w = A.mv(tree_get_row(V, j))
        c1 = space.project_rows(V, w)
        w = tree_sub(w, tree_basis_combine(V, c1))
        c2 = space.project_rows(V, w)
        w = tree_sub(w, tree_basis_combine(V, c2))
        h = c1 + c2
        b = space.norm(w)
        ok = b > tiny * torch.max(torch.abs(h))
        inv = torch.where(ok, 1.0 / torch.where(b > 0, b, torch.ones_like(b)), zero)
        H[:, j] = h
        H[j + 1, j] = torch.where(ok, b, zero)
        V = _set_row_if(V, j + 1, ok, tree_scale(inv, w))
    return H, V


def ritz_values(H) -> np.ndarray:
    """Eigenvalues of the leading square block of ``H``, on the host (an
    O(k³) LAPACK call on k ≲ 100); trailing all-zero breakdown columns are
    dropped first."""
    H = H.detach().cpu().numpy() if isinstance(H, torch.Tensor) else np.asarray(H)
    k = H.shape[1]
    Hk = H[:k, :]
    nz = np.flatnonzero(np.abs(Hk).sum(axis=0) > 0)
    m = int(nz[-1]) + 1 if nz.size else 0
    return np.linalg.eigvals(Hk[:m, :m])


def cond2_estimate(
    A,
    v0: Any = None,
    k: int = 64,
    *,
    space: Optional[VectorSpace] = None,
) -> torch.Tensor:
    """κ₂(A) = σ_max/σ_min by Lanczos on AᵀA, which needs ``A.rmv`` (a
    :class:`~newtonkrylov_tpu_torch.operator.JacobianOperator` has it).
    Exact to rounding at k = n; at small k an underestimate."""
    example = A.example_in if hasattr(A, "example_in") else A.u
    N = FnOperator(lambda v: A.rmv(A.mv(v)), example)
    if v0 is None:
        v0 = _default_start(example)
    lo, hi = extreme_eigs(N, v0, k, space=space)
    return torch.sqrt(hi / torch.clamp_min(lo, torch.finfo(lo.dtype).tiny))

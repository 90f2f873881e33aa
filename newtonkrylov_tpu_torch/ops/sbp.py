"""Summation-by-parts and DG derivative operators (examples/heat_1D_DG.jl).

Counterpart of ``newtonkrylov_tpu/ops/sbp.py``, whose numpy construction is
copied here (not imported), so the matrices are the JAX package's bit for
bit:

* :func:`periodic_upwind_operators` — biased finite-difference pairs
  ``(D_minus, D_plus)`` of accuracy order 1–3 on a uniform periodic grid;
* :func:`legendre_derivative_operator` — nodal Legendre-Gauss-Lobatto
  collocation derivative on [-1, 1];
* :func:`couple_discontinuously` — element-local operators glued into a
  global periodic upwind DG-SBP operator.

The construction runs in numpy on the host (operator setup is one-time);
the global operators are returned as tensors on an explicit ``device`` (by
default the card) and ``dtype``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import default_device

__all__ = [
    "periodic_upwind_operators",
    "legendre_derivative_operator",
    "UniformPeriodicMesh1D",
    "couple_discontinuously",
]


_UPWIND_COEFFS = {
    # accuracy_order: (offsets, coeffs) for the MINUS (backward-biased) stencil
    1: ([-1, 0], [-1.0, 1.0]),
    2: ([-2, -1, 0], [0.5, -2.0, 1.5]),
    3: ([-2, -1, 0, 1], [1.0 / 6.0, -1.0, 0.5, 1.0 / 3.0]),
}


def _tensor(a, dtype, device):
    return torch.tensor(a, dtype=dtype, device=device or default_device())


def periodic_upwind_operators(n: int, dx: float, accuracy_order: int = 3, *,
                              dtype=torch.float64, device=None):
    """Backward/forward-biased first-derivative pair on a periodic grid.

    Returns dense ``(n, n)`` tensors ``(D_minus, D_plus)`` with
    ``D_plus = -D_minusᵀ`` (the SBP adjoint pair), so ``D_minus @ D_plus``
    is a symmetric negative-semidefinite Laplacian.
    """
    offsets, coeffs = _UPWIND_COEFFS[accuracy_order]
    Dm = np.zeros((n, n))
    for off, c in zip(offsets, coeffs):
        for i in range(n):
            Dm[i, (i + off) % n] += c / dx
    Dp = -Dm.T
    return _tensor(Dm, dtype, device), _tensor(Dp, dtype, device)


def _lgl_nodes_weights(n: int):
    """Legendre-Gauss-Lobatto nodes/weights on [-1, 1] (n nodes, n ≥ 2)."""
    if n == 2:
        return np.array([-1.0, 1.0]), np.array([1.0, 1.0])
    from numpy.polynomial import legendre as L

    # interior nodes: the roots of P'_{n-1}
    c = np.zeros(n)
    c[-1] = 1.0
    dP = L.legder(c)
    interior = L.legroots(dP)
    x = np.concatenate([[-1.0], np.sort(interior), [1.0]])
    # weights w_i = 2 / (n(n-1) P_{n-1}(x_i)^2)
    Pn1 = L.legval(x, c)
    w = 2.0 / (n * (n - 1) * Pn1**2)
    return x, w


def legendre_derivative_operator(N: int):
    """Nodal LGL collocation derivative matrix and quadrature weights.

    Returns numpy ``(x, w, D)`` — the element-local input of
    :func:`couple_discontinuously`, as the JAX package returns it: ``x`` the
    N LGL nodes on [-1,1], ``w`` the quadrature weights (diagonal mass
    matrix), ``D`` the (N, N) differentiation matrix (exact on polynomials
    of degree < N), with the SBP property ``M D + (M D)ᵀ = B``,
    ``M = diag(w)``, ``B = diag(-1, 0, …, 0, 1)``.
    """
    x, w = _lgl_nodes_weights(N)
    # barycentric differentiation matrix
    X = x[:, None] - x[None, :]
    np.fill_diagonal(X, 1.0)
    lam = 1.0 / np.prod(X, axis=1)
    D = np.zeros((N, N))
    for i in range(N):
        for j in range(N):
            if i != j:
                D[i, j] = (lam[j] / lam[i]) / (x[i] - x[j])
        D[i, i] = -np.sum(D[i, [j for j in range(N) if j != i]])
    return x, w, D


class UniformPeriodicMesh1D:
    """Uniform periodic partition of [xmin, xmax] into Nx elements
    (cf. examples/heat_1D_DG.jl:21)."""

    def __init__(self, xmin: float, xmax: float, Nx: int):
        self.xmin = xmin
        self.xmax = xmax
        self.Nx = Nx
        self.h = (xmax - xmin) / Nx


def couple_discontinuously(local_op, mesh: UniformPeriodicMesh1D,
                           mode: str = "central", *, dtype=torch.float64,
                           device=None):
    """Global periodic DG-SBP derivative from an element-local LGL operator
    with upwind (``"minus"``: the value from the left element, ``"plus"``:
    from the right) or ``"central"`` interface coupling.

    ``local_op`` is the ``(x, w, D)`` triple of
    :func:`legendre_derivative_operator`.  Returns ``(x_global, D_global)``
    tensors of shapes (Nx·N,) and (Nx·N, Nx·N).  The plus operator is the
    M-weighted adjoint of the minus one, ``D₊ = −M⁻¹ D₋ᵀ M``, so ``D₋ @ D₊``
    is negative semidefinite in the M inner product.
    """
    x, w, D = local_op
    N = len(x)
    K = mesh.Nx
    J = mesh.h / 2.0  # affine map Jacobian

    n = K * N
    G = np.zeros((n, n))
    for k in range(K):
        s = k * N
        G[s : s + N, s : s + N] = D / J

    # SAT correction for the minus operator (left flux), DG strong form:
    #   D u + M⁻¹ e₁ (u₁ − u_{k−1,N}) / J
    tau_l = 1.0 / (w[0] * J)
    for k in range(K):
        s = k * N
        left_nb = ((k - 1) % K) * N + (N - 1)   # right endpoint of left element
        G[s, s] += tau_l
        G[s, left_nb] -= tau_l

    mg = np.tile(w * J, K)  # global diagonal mass matrix

    # D₊[i,j] = -(1/m_i) · D₋[j,i] · m_j
    Gplus = -(G.T * mg[None, :]) / mg[:, None]
    if mode == "minus":
        Gout = G
    elif mode == "plus":
        Gout = Gplus
    elif mode == "central":
        Gout = 0.5 * (G + Gplus)
    else:
        raise ValueError(f"unknown coupling mode {mode!r}")

    xg = np.concatenate([mesh.xmin + k * mesh.h + (x + 1.0) * J for k in range(K)])
    return _tensor(xg, dtype, device), _tensor(Gout, dtype, device)

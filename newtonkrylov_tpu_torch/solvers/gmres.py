"""Matrix-free GMRES / FGMRES.

Counterpart of ``newtonkrylov_tpu/solvers/gmres.py``, with its signature,
defaults and arithmetic:

* restarted cycles over a basis allocated once per cycle (``restart + 1``
  rows; ``restart=None`` is full GMRES with basis ``min(itmax, n)``),
  ``itmax = 2n`` and ``⌈itmax / m⌉`` cycles at most;
* CGS2 orthogonalization by default (one projection and one combination
  against the active basis per pass, ``reorthogonalize`` adds a pass),
  ``orth="mgs"`` sequential modified Gram–Schmidt, and ``ortho_block`` the
  chunked CGS2 projection of the reference;
* Givens rotations on the Hessenberg columns, with the reference's breakdown
  logic: a dependent column (``dep``, ρ ≤ max(breakdown_tol, 100·eps)·‖col‖)
  is excluded and ends the solve, a happy breakdown ends the cycle;
* ``flexible=True`` (FGMRES) stores the preconditioned directions Z.

The JAX package runs each cycle in ``lax.while_loop``.  Here the vectors
stay on the device and the small Hessenberg algebra runs on the host: each
Arnoldi step reads the new column ``h`` and ``‖w‖`` back together, once,
then applies the rotations, the ``dep``/happy/converged tests and the
update of ``g`` in numpy in the Krylov dtype (numpy rounds each float32 or
float64 multiply and add as the device does).  The tolerance ``rtol`` (a
device tensor from the Newton driver) is read once per solve with ‖r₀‖,
each later cycle reads its starting ‖r‖, and the coefficients ``y`` go to
the device once per cycle.  The basis products (``V[:k+1] @ w``,
``h @ V[:k+1]``) are ``torch.mv``; they touch only the active rows.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..spaces import EuclideanSpace, VectorSpace
from ..tree import (
    tree_add,
    tree_axpy,
    tree_basis_combine,
    tree_dtype,
    tree_get_row,
    tree_leaves,
    tree_map,
    tree_project_rows,
    tree_rows,
    tree_scale,
    tree_set_row,
    tree_size,
    tree_stack_like,
    tree_sub,
    tree_zeros_like,
)
from .common import KrylovResult, as_operator, default_tols

__all__ = ["gmres", "fgmres"]


def _orthogonalize(space, V, w, k, orth, reorthogonalize, ortho_block):
    """Orthogonalize w against rows 0..k of V: (w, h) with h the (k+1,)
    device vector of coefficients."""
    if ortho_block is not None:
        return _orthogonalize_blocked(space, V, w, k, ortho_block,
                                      reorthogonalize)
    npasses = 2 if reorthogonalize else 1
    if orth == "cgs2":
        Vk = tree_rows(V, k + 1)
        h = space.project_rows(Vk, w)
        w = tree_sub(w, tree_basis_combine(Vk, h))
        for _ in range(npasses):
            h2 = space.project_rows(Vk, w)
            w = tree_sub(w, tree_basis_combine(Vk, h2))
            h = h + h2
        return w, h
    # mgs: h[j] accumulates one coefficient per pass
    h = None
    for _ in range(npasses):
        hs = []
        for j in range(k + 1):
            vj = tree_get_row(V, j)
            hj = space.dot(vj, w)
            w = tree_axpy(-hj, vj, w)
            hs.append(hj)
        h = torch.stack(hs) if h is None else h + torch.stack(hs)
    return w, h


def _pad_rows(m: int, block: int) -> int:
    """Basis row allocation rounded up to a whole number of blocks."""
    return -(-(m + 1) // block) * block


def _orthogonalize_blocked(space, V, w, k, block, reorthogonalize):
    """CGS2 over the ⌈(k+1)/block⌉ basis chunks that hold active rows, the
    reference's ``_orthogonalize_blocked``: per-chunk projections
    accumulated into one vector, completed by ``space.reduce_rows`` and
    masked to rows ≤ k; the combination summed chunk by chunk."""
    nch = k // block + 1
    chunks = [tree_map(lambda l, i=i: l[i * block:(i + 1) * block], V)
              for i in range(nch)]

    def project(w_):
        mw = space.mask_tree(w_)
        h = space.reduce_rows(torch.cat([tree_project_rows(c, mw) for c in chunks]))
        return h * (torch.arange(h.shape[0], device=h.device) <= k)

    def combine(h):
        acc = tree_zeros_like(w)
        for i, c in enumerate(chunks):
            acc = tree_add(acc, tree_basis_combine(c, h[i * block:(i + 1) * block]))
        return acc

    h = project(w)
    w = tree_sub(w, combine(h))
    for _ in range(2 if reorthogonalize else 1):
        h2 = project(w)
        w = tree_sub(w, combine(h2))
        h = h + h2
    return w, h[:k + 1]


def _read(*scalars) -> np.ndarray:
    """Device scalars and vectors to the host in one transfer."""
    return torch.cat([s.reshape(-1) for s in scalars]).cpu().numpy()


def _gmres_cycle(Aop, Mop, Nop, x, r, beta, space, m, m_alloc, orth,
                 reorthogonalize, eps_abs, flexible, breakdown_tol,
                 ortho_block, dt):
    """One restart cycle from residual r of norm beta (a host scalar of the
    Krylov dtype ``dt``).  Returns (x_new, steps, resnorm, dep)."""
    one = dt.type(1)
    V = tree_stack_like(r, m_alloc)
    Z = tree_stack_like(r, m) if flexible else None
    tree_set_row(V, 0, tree_scale(float(one / (beta if beta > 0 else one)), r))

    R = np.zeros((m + 1, m), dt)
    cs = np.zeros(m, dt)
    sn = np.zeros(m, dt)
    g = np.zeros(m + 1, dt)
    g[0] = beta
    tiny = dt.type(100.0 * np.finfo(dt).eps)
    tol_dep = np.maximum(dt.type(breakdown_tol), tiny)
    btol = dt.type(breakdown_tol)

    k = keff = 0
    resnorm, done, dep_any = beta, bool(beta <= eps_abs), False
    while k < m and not done:
        vk = tree_get_row(V, k)
        z = Nop(vk) if Nop is not None else vk
        if flexible:
            tree_set_row(Z, k, z)
        w = Aop(z)
        if Mop is not None:
            w = Mop(w)
        w, h_dev = _orthogonalize(space, V, w, k, orth, reorthogonalize,
                                  ortho_block)
        col = _read(h_dev, space.norm(w))  # the step's one host read
        h = np.zeros(m + 1, dt)
        h[:k + 1] = col[:k + 1]
        hk1 = col[k + 1]

        for j in range(k):  # the stored rotations
            hj, hj1 = h[j], h[j + 1]
            h[j] = cs[j] * hj + sn[j] * hj1
            h[j + 1] = -sn[j] * hj + cs[j] * hj1
        hk = h[k]
        rho = np.sqrt(hk * hk + hk1 * hk1)
        # ρ ≈ 0 relative to the column: a dependent direction (serious
        # breakdown) — excluded, and the solve stops
        col_norm = np.sqrt(np.sum(h * h) + hk1 * hk1)
        dep = bool(rho <= tol_dep * np.maximum(col_norm, dt.type(1e-30)))
        if dep or rho == 0:
            c_new, s_new = one, dt.type(0)
        else:
            c_new, s_new = hk / rho, hk1 / rho
        if not dep:
            h[k] = rho
            gk = g[k]
            g[k], g[k + 1] = c_new * gk, -s_new * gk
            resnorm = abs(g[k + 1])
            keff = k + 1
        cs[k], sn[k] = c_new, s_new
        R[:, k] = h
        happy = not dep and bool(hk1 <= btol * np.maximum(rho, one))
        done = bool(resnorm <= eps_abs) or happy or dep
        dep_any = dep_any or dep
        k += 1
        if not done and k < m:
            tree_set_row(V, k, tree_scale(float(one / (hk1 if hk1 > 0 else one)), w))

    if keff == 0:
        return x, k, resnorm, dep_any
    # back-substitution on the rotated (upper-triangular) system R y = g
    y = np.zeros(keff, dt)
    for i in range(keff - 1, -1, -1):
        num = g[i] - R[i, :keff] @ y
        y[i] = num / (R[i, i] if R[i, i] != 0 else one)
    yk = torch.from_numpy(y).to(tree_leaves(x)[0].device)
    if flexible:
        dx = tree_basis_combine(tree_rows(Z, keff), yk)
    else:
        dx = tree_basis_combine(tree_rows(V, keff), yk)
        if Nop is not None:
            dx = Nop(dx)
    return tree_add(x, dx), k, resnorm, dep_any


def gmres(
    A,
    b,
    x0=None,
    *,
    restart: Optional[int] = 20,
    itmax: Optional[int] = None,
    atol: Optional[float] = None,
    rtol=None,
    M: Optional[Callable] = None,
    N: Optional[Callable] = None,
    space: Optional[VectorSpace] = None,
    orth: str = "cgs2",
    reorthogonalize: bool = False,
    flexible: bool = False,
    breakdown_tol: float = 0.0,
    ortho_block: Optional[int] = None,
) -> KrylovResult:
    """Solve A x = b with restarted (F)GMRES.

    Stops when ``‖r‖ ≤ atol + rtol·‖r₀‖`` (``rtol`` may be a 0-d tensor,
    η from the Newton driver) or after ``itmax`` total Arnoldi steps.
    ``restart`` is the per-cycle basis size; ``restart=None`` gives full
    GMRES with basis ``min(itmax, n)``, allocated up front.  ``M`` (left)
    and ``N`` (right) apply preconditioner inverses; ``flexible=True``
    lets ``N`` change between steps.  ``ortho_block=C`` runs the CGS2
    projection over C-row basis chunks (requires ``orth="cgs2"``).
    """
    Aop = as_operator(A)
    Mop = as_operator(M) if M is not None else None
    Nop = as_operator(N) if N is not None else None
    space = space or EuclideanSpace()
    if orth not in ("cgs2", "mgs"):
        raise ValueError(f"unknown orthogonalization {orth!r}")
    if ortho_block is not None:
        if orth != "cgs2":
            raise ValueError("ortho_block requires orth='cgs2'")
        if ortho_block < 1:
            raise ValueError("ortho_block must be a positive int")

    if x0 is None:
        x0 = tree_zeros_like(b)
    dtype = tree_dtype(b)
    dt = torch.empty((), dtype=dtype).numpy().dtype
    atol, rtol = default_tols(dtype, atol, rtol)

    n = tree_size(b)
    if itmax is None:
        itmax = 2 * n * space.size_multiplier()
    m = min(restart, n) if restart is not None else min(itmax, n)
    max_cycles = max(1, -(-itmax // m))
    m_alloc = _pad_rows(m, ortho_block) if ortho_block is not None else m + 1

    def residual(x):
        r = tree_sub(b, Aop(x))
        if Mop is not None:
            r = Mop(r)
        return space.mask_tree(r)

    r = residual(x0)
    beta_dev = space.norm(r)
    beta0, rtol_h = _read(beta_dev, torch.as_tensor(rtol, dtype=dtype,
                                                    device=beta_dev.device))
    eps_abs = dt.type(atol) + rtol_h * beta0

    x, beta = x0, beta0
    total = cycle = 0
    resnorm, converged, breakdown = beta0, bool(beta0 <= eps_abs), False
    while not converged and total < itmax and cycle < max_cycles:
        if cycle > 0:
            r = residual(x)
            (beta,) = _read(space.norm(r))
        x, k, resnorm, dep = _gmres_cycle(
            Aop, Mop, Nop, x, r, beta, space, m, m_alloc, orth,
            reorthogonalize, eps_abs, flexible, breakdown_tol, ortho_block, dt)
        total += k
        converged = bool(resnorm <= eps_abs)
        breakdown = breakdown or dep
        # a dependent direction ends the solve: restarting would rebuild
        # the same exhausted space
        cycle = max_cycles if dep else cycle + 1

    device = beta_dev.device
    return KrylovResult(
        x, total, torch.tensor(resnorm, dtype=dtype, device=device),
        torch.tensor(converged, device=device),
        torch.tensor(breakdown, device=device))


def fgmres(A, b, x0=None, **kwargs) -> KrylovResult:
    """Flexible GMRES: the right preconditioner may vary per step (e.g. an
    inner Krylov solve)."""
    kwargs.setdefault("flexible", True)
    return gmres(A, b, x0, **kwargs)

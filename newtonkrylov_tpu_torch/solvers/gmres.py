"""Matrix-free GMRES / FGMRES.

Counterpart of ``newtonkrylov_tpu/solvers/gmres.py``, with its signature,
defaults, arithmetic and loop structure:

* restarted cycles over a basis allocated once per cycle (``restart + 1``
  rows; ``restart=None`` is full GMRES with basis ``min(itmax, n)``),
  ``itmax = 2n`` and ``⌈itmax / m⌉`` cycles at most;
* CGS2 orthogonalization by default (one projection and one combination
  against the basis per pass, rows past the active ones masked;
  ``reorthogonalize`` adds a pass), ``orth="mgs"`` sequential modified
  Gram–Schmidt, and ``ortho_block`` the chunked CGS2 projection of the
  reference, whose trip count follows the active basis;
* Givens rotations on the Hessenberg columns, with the reference's breakdown
  logic: a dependent column (``dep``, ρ ≤ max(breakdown_tol, 100·eps)·‖col‖)
  is excluded and ends the solve, a happy breakdown ends the cycle;
* ``flexible=True`` (FGMRES) stores the preconditioned directions Z.

Each cycle is an :func:`~newtonkrylov_tpu_torch.exportable.while_loop`
over one Arnoldi step, and the restarts a second one around it, as the JAX
package's ``lax.while_loop``\\ s.  The carry is fixed-shape device tensors
in the Krylov dtype: the basis V (and Z), the rotated Hessenberg R
((m+1) × m), the rotations, g, the step count, ``keff`` (the columns not
excluded as dependent, masked rather than sliced), ‖r‖ and the
``done``/``dep`` flags.  Eagerly the loop reads one boolean a step and the
step count stays a Python int, so the rotations, the MGS sweep, the
chunked projection and the back-substitution loop over it with no read;
under ``torch.export`` those loops are nested ``while_loop``\\ s over a
tensor count, and the loaded program runs the same ops as the live solve.

The small algebra rounds as numpy rounded it when the port kept it on the
host: each rotation is separate multiplies and adds (no fused op, which
could contract to an FMA), and the column norm of the breakdown test sums
in numpy's pairwise order (:func:`_pairwise_sum`).  The back-substitution's
dot products cannot round as numpy's BLAS did, so f32 counts may differ
from the host-side version's (ROADMAP Queue 3 item 10).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..exportable import counter, exporting, fori_loop, while_loop
from ..spaces import EuclideanSpace, VectorSpace
from ..tree import (
    tree_add,
    tree_axpy,
    tree_basis_combine,
    tree_dtype,
    tree_map,
    tree_project_rows,
    tree_scale,
    tree_set_row,
    tree_size,
    tree_stack_like,
    tree_sub,
    tree_zeros_like,
)
from .common import KrylovResult, as_operator, default_tols

__all__ = ["gmres", "fgmres"]


def _put(vec, i, value, pos):
    """``vec`` with entry ``i`` set to ``value`` (``pos``: arange over
    ``vec``'s first axis), without mutating it."""
    sel = (pos == i).reshape((-1,) + (1,) * (vec.dim() - 1))
    return torch.where(sel, value, vec)


def _at(t, i):
    """``t[i]`` for an int ``i``, or a 0-d index tensor in an export (which
    traces ``t[i]`` as a read of the index's value)."""
    if isinstance(i, int):
        return t[i]
    return t.index_select(0, i.reshape(1)).squeeze(0)


def _row(V, i):
    """Row ``i`` (an int or a 0-d tensor) of a stacked basis."""
    return tree_map(lambda l: _at(l, i), V)


def _with_row(V, i, x):
    """``V`` with row ``i`` set to ``x``: in place eagerly (the basis is
    allocated once per cycle), an updated copy when exporting (a
    ``while_loop`` body may not write to its carried state)."""
    if not exporting():
        return tree_set_row(V, i, x)
    return tree_map(lambda l, xl: l.index_copy(0, i.reshape(1), xl.unsqueeze(0)),
                    V, x)


def _pairwise_plan(n: int, device):
    """Gather indices that sum a length-``n`` vector in numpy's
    ``pairwise_sum`` order: the ``(leaves, blocks, 8)`` block indices and
    ``(leaves, 7)`` tail indices of the recursion's leaves (index ``n``
    names a zero pad), and the recursion as a tree over the leaves.  None
    for n < 8, which numpy sums left to right."""
    if n < 8:
        return None
    leaves = []

    def split(lo, m):
        if m <= 128:
            leaves.append((lo, m))
            return len(leaves) - 1
        m2 = m // 2
        m2 -= m2 % 8
        return (split(lo, m2), split(lo + m2, m - m2))

    tree = split(0, n)
    nb = 0  # the most blocks of a leaf (no max(): see gmres)
    for _, m in leaves:
        nb = m // 8 if m // 8 > nb else nb

    def indices(first, count, width):  # first + [0, count), padded by n
        idx = torch.arange(first, first + count, device=device)
        return torch.cat([idx, torch.full((width - count,), n, device=device)])

    # factory ops only: the plan may be built inside a loop body
    blocks = torch.stack([indices(lo, m - m % 8, 8 * nb).reshape(nb, 8)
                          for lo, m in leaves])
    tails = torch.stack([indices(lo + m - m % 8, m % 8, 7) for lo, m in leaves])
    return blocks, tails, tree


def _pairwise_sum(x, plan):
    """Σ x of a non-negative vector in numpy's pairwise order (``np.sum``
    of a contiguous float array): per leaf of ≤ 128 entries eight
    accumulators over blocks of eight, combined ((r0+r1)+(r2+r3)) +
    ((r4+r5)+(r6+r7)), then the leftover entries one by one; leaves joined
    as the recursion halves.  Pads add +0 to a non-negative sum, which
    changes no bit."""
    if plan is None:
        out = x[0]
        for i in range(1, x.shape[0]):
            out = out + x[i]
        return out
    blocks, tails, tree = plan
    xp = torch.cat([x, x.new_zeros(1)])
    b = xp[blocks]
    r = b[:, 0]
    for j in range(1, b.shape[1]):
        r = r + b[:, j]
    r = r[:, 0::2] + r[:, 1::2]
    r = r[:, 0::2] + r[:, 1::2]
    res = r[:, 0] + r[:, 1]
    t = xp[tails]
    for j in range(7):
        res = res + t[:, j]

    def join(node):
        if isinstance(node, int):
            return res[node]
        return join(node[0]) + join(node[1])

    return join(tree)


class _Cycle:
    """One restart cycle's invariants: the operators, the options and the
    constants its body reads (made ahead of any loop: a ``while_loop``
    body may not create a tensor constant)."""

    def __init__(self, Aop, Mop, Nop, space, m, m_alloc, orth,
                 reorthogonalize, flexible, breakdown_tol, ortho_block,
                 eps_abs, dtype, device):
        self.Aop, self.Mop, self.Nop, self.space = Aop, Mop, Nop, space
        # sizes are read back from tensor shapes (``m``, ``m_alloc``): an
        # export traces an int attribute read in a loop body as an input
        self.orth, self.reorthogonalize = orth, reorthogonalize
        self.flexible, self.ortho_block = flexible, ortho_block
        self.eps_abs = eps_abs

        def const(v):
            return torch.full((), v, dtype=dtype, device=device)

        eps = torch.finfo(dtype).eps
        self.one, self.zero = const(1.0), const(0.0)
        # rounded to the dtype as numpy's dt.type(...) rounded them
        self.tol_dep = torch.maximum(const(breakdown_tol), const(100.0 * eps))
        self.btol, self.floor = const(breakdown_tol), const(1e-30)
        self.rows = torch.arange(m_alloc, device=device)  # basis rows
        self.pos = torch.arange(m + 1, device=device)     # entries of h, g
        self.cols = torch.arange(m, device=device)        # columns of R
        self.sum_plan = _pairwise_plan(m + 1, device)
        if ortho_block is not None:
            self.offsets = torch.arange(ortho_block, device=device)
            self.chunk_of = self.rows // ortho_block  # each row's chunk

    @property
    def m(self) -> int:
        return self.cols.shape[0]

    @property
    def m_alloc(self) -> int:
        return self.rows.shape[0]

    @property
    def npasses(self) -> int:
        return 2 if self.reorthogonalize else 1

    # -- orthogonalization ------------------------------------------------
    def orthogonalize(self, V, w, k):
        """w orthogonalized against rows 0..k of V, and h (m + 1 entries,
        zero past k)."""
        if self.ortho_block is not None:
            return self._blocked(V, w, k)
        space = self.space
        if self.orth == "cgs2":
            mask = (self.rows <= k).to(tree_dtype(w))
            h = space.project_rows(V, w) * mask
            w = tree_sub(w, tree_basis_combine(V, h))
            for _ in range(self.npasses):
                h2 = space.project_rows(V, w) * mask
                w = tree_sub(w, tree_basis_combine(V, h2))
                h = h + h2
            return w, h[:self.pos.shape[0]]

        def sweep(j, w, h):  # mgs: h[j] accumulates one coefficient a pass
            vj = _row(V, j)
            hj = space.dot(vj, w)
            return tree_axpy(-hj, vj, w), _put(h, j, _at(h, j) + hj, self.pos)

        h = torch.zeros_like(self.pos, dtype=tree_dtype(w))
        for _ in range(self.npasses):
            w, h = fori_loop(0, k + 1, sweep, (w, h), like=self.pos)
        return w, h

    def _blocked(self, V, w, k):
        """CGS2 over the ⌈(k+1)/block⌉ basis chunks that hold active rows
        (the reference's ``_orthogonalize_blocked``): per-chunk projections
        gathered into one vector, completed by ``space.reduce_rows`` and
        masked to rows ≤ k; the combination summed chunk by chunk."""
        offsets, space = self.offsets, self.space
        nch = k // offsets.shape[0] + 1
        # the nested loops read the block size from ``offsets`` themselves:
        # an int they closed over would become an input of their loop

        def chunk(i):
            block = offsets.shape[0]
            if not exporting():
                return tree_map(lambda l: l[i * block:(i + 1) * block], V)
            return tree_map(lambda l: l.index_select(0, i * block + offsets), V)

        def project(w_):
            mw = space.mask_tree(w_)

            def part(i, h):
                hc = tree_project_rows(chunk(i), mw)
                reps = self.rows.shape[0] // offsets.shape[0]
                return (torch.where(self.chunk_of == i, hc.repeat(reps), h),)

            (h,) = fori_loop(0, nch, part, (torch.zeros_like(
                self.rows, dtype=tree_dtype(w_)),), like=self.rows)
            return space.reduce_rows(h) * (self.rows <= k)

        def combine(h):
            def part(i, acc):
                hc = h.index_select(0, i * offsets.shape[0] + offsets)
                return (tree_add(acc, tree_basis_combine(chunk(i), hc)),)

            return fori_loop(0, nch, part, (tree_zeros_like(w),),
                             like=self.rows)[0]

        h = project(w)
        w = tree_sub(w, combine(h))
        for _ in range(self.npasses):
            h2 = project(w)
            w = tree_sub(w, combine(h2))
            h = h + h2
        return w, h[:self.pos.shape[0]]

    # -- the rotations ----------------------------------------------------
    def rotate(self, G, h, k):
        """The stored rotations 0..k-1 applied to column h, in order:
        ``(h_j, h_j+1) ← (c h_j + s h_j+1, −s h_j + c h_j+1)``.  ``G[j]`` is
        ``[[c, −s], [s, c]]``.  Rotation j reads h_j+1 before any rotation
        has touched it, so the products ``h_j+1·(s, c)`` are formed for
        every j at once; the chain through t_j = h_j (as rotated so far)
        is one multiply of a pair and one add a rotation."""
        if not exporting():
            hs = h[1:k + 1, None] * G[:k, 1]
            outs, t = [], h[0]
            for j in range(k):
                new = t * G[j, 0] + hs[j]
                outs.append(new[0])
                t = new[1]
            return torch.cat([torch.stack(outs + [t]), h[k + 1:]])

        hs = h[1:, None] * G[:, 1]

        def turn(j, t, out):
            new = t * _at(G, j)[0] + _at(hs, j)
            return new[1], _put(out, j, new[0], self.pos)

        t, out = fori_loop(0, k, turn, (h[0], h), like=self.pos)
        return _put(out, k, t, self.pos)

    # -- one Arnoldi step -------------------------------------------------
    def step(self, k, keff, V, Z, R, G, g, resnorm, done, dep_any):
        one, zero, pos = self.one, self.zero, self.pos
        vk = _row(V, k)
        z = self.Nop(vk) if self.Nop is not None else vk
        if self.flexible:
            Z = _with_row(Z, k, z)
        w = self.Aop(z)
        if self.Mop is not None:
            w = self.Mop(w)
        w, h = self.orthogonalize(V, w, k)
        hk1 = self.space.norm(w)

        h = self.rotate(G, h, k)
        hk = _at(h, k)
        rho = torch.sqrt(hk * hk + hk1 * hk1)
        # ρ ≈ 0 relative to the column: a dependent direction (serious
        # breakdown) — excluded, and the solve stops
        col_norm = torch.sqrt(_pairwise_sum(h * h, self.sum_plan) + hk1 * hk1)
        dep = rho <= self.tol_dep * torch.maximum(col_norm, self.floor)
        ident = dep | (rho == 0)
        safe_rho = torch.where(rho > 0, rho, one)
        c = torch.where(ident, one, hk / safe_rho)
        s = torch.where(ident, zero, hk1 / safe_rho)
        h = _put(h, k, torch.where(dep, hk, rho), pos)
        gk = _at(g, k)
        g_new = _put(_put(g, k, c * gk, pos), k + 1, -s * gk, pos)
        g = torch.where(dep, g, g_new)
        resnorm = torch.where(dep, resnorm, torch.abs(_at(g, k + 1)))
        keff = torch.where(dep, keff, k + 1)
        G = _put(G, k, torch.stack([torch.stack([c, -s]),
                                    torch.stack([s, c])]), self.cols)
        R = torch.where(self.cols == k, h[:, None], R)
        happy = ~dep & (hk1 <= self.btol * torch.maximum(rho, one))
        done = (resnorm <= self.eps_abs) | happy | dep
        safe_h = torch.where(hk1 > 0, hk1, one)
        V = _with_row(V, k + 1, tree_scale(one / safe_h, w))
        return k + 1, keff, V, Z, R, G, g, resnorm, done, dep_any | dep

    def back_substitute(self, R, g, k, keff):
        """y with R y = g on rows < keff (rows from keff on are zero), by a
        loop down from row k − 1 with the inactive rows masked."""
        m = self.m

        def row(i_rev, y):
            i = k - 1 - i_rev
            Ri = _at(R, i)
            num = _at(g, i) - torch.dot(Ri, y)
            active = i < keff
            rii = _at(Ri, i)
            denom = torch.where(active & (rii != 0), rii, self.one)
            return (_put(y, i, torch.where(active, num / denom, self.zero),
                         self.cols),)

        y = torch.zeros(m, dtype=R.dtype, device=R.device)
        return fori_loop(0, k, row, (y,), like=self.cols)[0]

    def run(self, x, r, beta):
        """One cycle from residual r of norm beta (a 0-d tensor): (x_new,
        steps, resnorm, dep)."""
        m, one = self.m, self.one
        dtype = beta.dtype
        V = tree_stack_like(r, self.m_alloc)
        V = _with_row(V, counter(beta), tree_scale(
            one / torch.where(beta > 0, beta, one), r))
        # the directions N v of FGMRES; none to carry otherwise
        Z = tree_stack_like(r, m) if self.flexible else ()
        R = torch.zeros((m + 1, m), dtype=dtype, device=beta.device)
        G = torch.zeros((m, 2, 2), dtype=dtype, device=beta.device)
        g = _put(torch.zeros(m + 1, dtype=dtype, device=beta.device), 0, beta,
                 self.pos)
        limit = counter(beta, m)
        done = beta <= self.eps_abs
        carry = (counter(beta), counter(beta), V, Z, R, G, g, beta, done,
                 torch.zeros_like(done))

        def cond(k, keff, V, Z, R, G, g, resnorm, done, dep):
            return (k < limit) & ~done

        k, keff, V, Z, R, G, g, resnorm, _, dep = while_loop(cond, self.step,
                                                             carry)
        y = self.back_substitute(R, g, k, keff)
        if self.flexible:
            dx = tree_basis_combine(Z, y)
        else:
            coeffs = torch.cat([y, y.new_zeros(self.m_alloc - m)])
            dx = tree_basis_combine(V, coeffs)
            if self.Nop is not None:
                dx = self.Nop(dx)
        return tree_add(x, dx), k, resnorm, dep


def _pad_rows(m: int, block: int) -> int:
    """Basis row allocation rounded up to a whole number of blocks."""
    return -(-(m + 1) // block) * block


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
    ``niter`` is a Python int eagerly, a 0-d tensor in an export.
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
    atol, rtol = default_tols(dtype, atol, rtol)

    # no min/max here: inside an exported loop body the sizes are symbolic,
    # and Dynamo's max(1, s) returned 1 (conditional expressions trace)
    n = tree_size(b)
    if itmax is None:
        itmax = 2 * n * space.size_multiplier()
    cap = restart if restart is not None else itmax
    m = cap if cap < n else n
    max_cycles = -(-itmax // m)
    max_cycles = max_cycles if max_cycles > 1 else 1
    m_alloc = _pad_rows(m, ortho_block) if ortho_block is not None else m + 1

    def residual(x):
        r = tree_sub(b, Aop(x))
        if Mop is not None:
            r = Mop(r)
        return space.mask_tree(r)

    r = residual(x0)
    beta0 = space.norm(r)
    device = beta0.device
    def scalar(v):  # a factory op, not a constant: this may run in a body
        if isinstance(v, torch.Tensor):
            return v.to(dtype)
        return torch.full((), v, dtype=dtype, device=device)

    eps_abs = scalar(atol) + scalar(rtol) * beta0
    cyc = _Cycle(Aop, Mop, Nop, space, m, m_alloc, orth, reorthogonalize,
                 flexible, breakdown_tol, ortho_block, eps_abs, dtype, device)
    itmax_c, cycles_c = counter(beta0, itmax), counter(beta0, max_cycles)

    def outcome(x, total, k, resnorm, breakdown, dep, cycle):
        # a dependent direction ends the solve (``breakdown`` stops the
        # loop): restarting would rebuild the same exhausted space
        return (x, total + k, resnorm, resnorm <= eps_abs, breakdown | dep,
                cycle + 1)

    converged = beta0 <= eps_abs
    state = (x0, counter(beta0), beta0, converged,
             torch.zeros_like(converged), counter(beta0))
    # the first cycle starts from r₀; an eager solve reads the test the
    # loop would read first
    if itmax > 0 and (exporting() or not bool(converged)):
        x, k, resnorm, dep = cyc.run(x0, r, beta0)
        state = outcome(x, state[1], k, resnorm, state[4], dep, state[5])

    def cond(x, total, resnorm, converged, breakdown, cycle):
        return ~(converged | breakdown) & (total < itmax_c) & (cycle < cycles_c)

    def body(x, total, resnorm, converged, breakdown, cycle):
        r = residual(x)
        x_new, k, resnorm, dep = cyc.run(x, r, space.norm(r))
        return outcome(x_new, total, k, resnorm, breakdown, dep, cycle)

    x, total, resnorm, converged, breakdown, _ = while_loop(cond, body, state)
    return KrylovResult(x, total, resnorm, converged, breakdown)


def fgmres(A, b, x0=None, **kwargs) -> KrylovResult:
    """Flexible GMRES: the right preconditioner may vary per step (e.g. an
    inner Krylov solve)."""
    kwargs.setdefault("flexible", True)
    return gmres(A, b, x0, **kwargs)

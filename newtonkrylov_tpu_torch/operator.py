"""Matrix-free Jacobian operators backed by PyTorch AD.

Counterpart of ``newtonkrylov_tpu/operator.py``.  The residual is
linearized once per Newton iteration.  The Newton drivers trace its J·v
once a solve (:func:`~newtonkrylov_tpu_torch.exportable.jvp_graph`, eagerly
and under an export alike) into two FX graphs: the linearization, which
reads only the state and the parameters (``exp(u)`` and the like) and is
evaluated at each new point, and the tangent map, which every Krylov
matvec replays.  An operator built without such a graph, or in a solve
whose residual cannot be traced with fake tensors, linearizes with
:func:`torch.func.linearize`, which makes the same split by tracing the
tangent map at the point and folding the rest into constants.

The adjoint ``Jᵀw`` is the :func:`torch.func.vjp` of ``F(·, p)`` at ``u``
(the JAX package transposes its stored JVP), built on first use and kept
with the operator.  The materializers probe the operator with basis or
striped (colored) vectors, one replayed matvec each (a loop, as
:meth:`JacobianOperator.mm`).

A hand-written kernel reached from a residual must be a
``torch.library.custom_op`` with a fake registration (as in
:mod:`newtonkrylov_tpu_torch.kernels.stencil2d`): both linearizations
trace with ``make_fx``, where a raw foreign call would see tracing tensors.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable

import numpy as np
import torch

from .exportable import exporting
from .exportable import jvp_graph as _jvp_graph
from .exportable import vjp_graph as _vjp_graph
from .tree import tree_dtype, tree_leaves, tree_map, tree_size
from .utils.profiling import span

__all__ = [
    "LinearOperator",
    "JacobianOperator",
    "AdjointOperator",
    "ShiftedOperator",
    "materialize_dense",
    "materialize_banded",
    "materialize_csr",
    "stencil_coloring",
]


class LinearOperator:
    """Minimal protocol: a linear map is a callable state → state."""

    def mv(self, v):
        raise NotImplementedError

    def __call__(self, v):
        return self.mv(v)


class JacobianOperator(LinearOperator):
    """Lazy J = ∂F/∂u at a linearization point.

    ``F(u, p) -> res`` is a pure residual; ``p`` is held constant.
    ``res`` is F(u, p).  Given ``jvp_graph``
    (:func:`~newtonkrylov_tpu_torch.exportable.jvp_graph` of ``F`` at
    states and parameters shaped like ``u`` and ``p``, which the Newton
    drivers trace once a solve), the operator evaluates the graph's
    linearization at ``u`` here and each J·v replays only the tangent map,
    as the linearize graph does; ``res`` is then evaluated on first use.
    Without one it linearizes with :func:`torch.func.linearize`, which
    returns ``res`` with the linearization, or, under
    :func:`torch.export.export`, traces the graph itself.  Under an export
    ``Jᵀw`` replays ``vjp_graph``
    (:func:`~newtonkrylov_tpu_torch.exportable.vjp_graph`) the same way.
    """

    def __init__(self, F: Callable, u: Any, p: Any = None,
                 jvp_graph: Callable = None, vjp_graph: Callable = None):
        self.F = F
        self.u = u
        self.p = p
        self._res = None
        self._vjp = None  # built on first use; most solves never need it
        self._vjp_graph = vjp_graph
        if exporting():
            # an export replays the linearization as a traced J·v graph
            # (built here unless a driver built it ahead of its loop)
            graph = jvp_graph or _jvp_graph(F, u, p)
            self._res = F(u, p)
            self._jvp = graph.linearize(u, p)
            return
        if jvp_graph is not None:
            with span("linearize"):
                self._jvp = jvp_graph.linearize(u, p)
            return
        with span("linearize"), span("linearize.trace"), \
                warnings.catch_warnings():
            # linearize's constant folding builds its folded module before
            # attaching the constants it references and warns about it;
            # the module it returns is complete
            warnings.filterwarnings(
                "ignore", message="Attempted to insert a get_attr Node",
                category=UserWarning)
            self._res, self._jvp = torch.func.linearize(
                lambda uu: F(uu, p), u)

    @property
    def res(self):
        """F(u, p): the linearization's primal, or evaluated on first use
        where a traced graph linearized."""
        if self._res is None:
            self._res = self.F(self.u, self.p)
        return self._res

    def mv(self, v):
        """J @ v by replaying the stored linearization."""
        return self._jvp(v)

    def mm(self, V):
        """J @ [v₁…v_b] for tangents stacked on a leading axis.

        A loop over the replayed map: ``torch.func.vmap`` would need a
        batching rule for every custom kernel the residual reaches.
        """
        return torch.stack([self._jvp(v) for v in V])

    def _get_vjp(self):
        if self._vjp is None:
            if exporting():
                # evaluated where the first Jᵀw is asked for, ahead of the
                # Krylov loop that replays it (CGLS forms Aᵀb first)
                graph = self._vjp_graph or _vjp_graph(self.F, self.u, self.p)
                lin = graph.linearize(self.u, self.p)
                self._vjp = lambda w: (lin(w),)
            else:
                _, self._vjp = torch.func.vjp(lambda uu: self.F(uu, self.p),
                                              self.u)
        return self._vjp

    def rmv(self, w):
        """Jᵀ @ w through the cached ``torch.func.vjp`` of F at u."""
        (out,) = self._get_vjp()(w)
        return out

    def rmm(self, W):
        """Jᵀ @ [w₁…w_b], a loop over :meth:`rmv`."""
        return torch.stack([self.rmv(w) for w in W])

    @property
    def T(self) -> "AdjointOperator":
        return AdjointOperator(self)

    @property
    def shape(self):
        return (tree_size(self.res), tree_size(self.u))

    @property
    def dtype(self):
        return tree_dtype(self.u)

    def materialize(self):
        """The dense (M, N) Jacobian (flattened row and column order)."""
        return materialize_dense(self)


class ShiftedOperator(LinearOperator):
    """αI + J as an operator (square operators only): the step operator of
    pseudo-transient continuation, ``(δ⁻¹ I + J) d = F(u)``.

    Passes the wrapped operator's ``u``/``res``/``F``/``p`` through, so the
    probing preconditioner factories see the shifted diagonal through
    :meth:`mv`.  ``u`` falls back to the operand's ``example_in``; the other
    attributes are None where the operand has none.
    """

    def __init__(self, J, alpha):
        self.J = J
        self.alpha = alpha  # a Python number or a 0-d tensor

    @property
    def u(self):
        u = getattr(self.J, "u", None)
        if u is None:
            u = getattr(self.J, "example_in", None)
        if u is None:
            raise AttributeError(
                f"ShiftedOperator operand {type(self.J).__name__} exposes "
                "neither 'u' nor 'example_in'; probing factories need an "
                "example input")
        return u

    @property
    def res(self):
        return getattr(self.J, "res", None)

    @property
    def F(self):
        return getattr(self.J, "F", None)

    @property
    def p(self):
        return getattr(self.J, "p", None)

    def _shift(self, jv, v):
        """jv + α·v, α rounded to each leaf's dtype."""
        a = self.alpha
        return tree_map(
            lambda j, l: j + (a.to(l) if isinstance(a, torch.Tensor) else a) * l,
            jv, v)

    def mv(self, v):
        return self._shift(self.J.mv(v), v)

    def mm(self, V):
        return torch.stack([self.mv(v) for v in V])

    def rmv(self, w):
        return self._shift(self.J.rmv(w), w)

    def rmm(self, W):
        return torch.stack([self.rmv(w) for w in W])

    @property
    def T(self):
        return AdjointOperator(self)

    @property
    def shape(self):
        return self.J.shape

    @property
    def dtype(self):
        return self.J.dtype

    @property
    def example_in(self):
        return self.u

    def materialize(self):
        return materialize_dense(self)


class AdjointOperator(LinearOperator):
    """Jᵀ as an operator."""

    def __init__(self, J):
        self.J = J

    def mv(self, v):
        return self.J.rmv(v)

    def mm(self, V):
        return self.J.rmm(V)

    @property
    def T(self):
        return self.J

    @property
    def shape(self):
        m, n = self.J.shape
        return (n, m)

    def materialize(self):
        return materialize_dense(self)


def _flatten(x):
    """A state as one flat tensor (leaves concatenated)."""
    leaves = tree_leaves(x)
    if len(leaves) == 1:
        return leaves[0].reshape(-1)
    return torch.cat([l.reshape(-1) for l in leaves])


def _unflatten_like(example):
    """The inverse of :func:`_flatten` for states shaped like ``example``."""
    leaves = tree_leaves(example)
    if len(leaves) == 1:
        shape = leaves[0].shape
        return lambda flat: flat.reshape(shape)
    sizes = [l.numel() for l in leaves]

    def unflatten(flat):
        parts = iter(p.reshape(l.shape)
                     for p, l in zip(torch.split(flat, sizes), leaves))
        return tree_map(lambda _: next(parts), example)

    return unflatten


def _probe(A, E, example):
    """(rows of E) ↦ flattened A·e for each row e, shape (rows, M)."""
    unflatten = _unflatten_like(example)
    return torch.stack([_flatten(A.mv(unflatten(e))) for e in E])


def materialize_dense(A: LinearOperator) -> torch.Tensor:
    """Probe A with all N basis vectors → the dense (M, N) matrix."""
    if isinstance(A, AdjointOperator):
        example_in = A.J.res
    elif isinstance(A, JacobianOperator):
        example_in = A.u
    else:
        example_in = A.example_in
    flat0 = _flatten(example_in)
    eye = torch.eye(flat0.numel(), dtype=flat0.dtype, device=flat0.device)
    return _probe(A, eye, example_in).T


def _striped_probes(flat_u, c: int):
    """The c striped vectors e_k = Σ_j δ_{j mod c, k} over a flat state."""
    idx = torch.arange(flat_u.numel(), device=flat_u.device)
    return torch.stack([(idx % c == k).to(flat_u.dtype) for k in range(c)])


def materialize_banded(J: JacobianOperator, lower: int, upper: int):
    """Colored probing of a banded Jacobian: lower + upper + 1 JVPs.

    Returns ``(offsets, diags)`` in DIA format, ``diags[d][i] =
    J[i, i + offsets[d]]`` (zero where the column falls outside), as
    tensors on the state's device.
    """
    c = lower + upper + 1
    flat_u = _flatten(J.u)
    n = flat_u.numel()
    outs = _probe(J, _striped_probes(flat_u, c), J.u)  # (c, M)
    idx = torch.arange(n, device=flat_u.device)
    offsets = list(range(-lower, upper + 1))
    diags = []
    for off in offsets:
        # column j = i + off has color (i + off) mod c: its entry is outs[color][i]
        cols = idx + off
        vals = outs[cols % c, idx]
        diags.append(torch.where((cols >= 0) & (cols < n), vals,
                                 torch.zeros_like(vals)))
    return torch.tensor(offsets, device=flat_u.device), torch.stack(diags)


def stencil_coloring(offsets) -> int:
    """Smallest stripe period c such that all offsets are distinct mod c:
    striped probes then recover column j = i + off from output j mod c
    without aliasing (the bandwidth for a contiguous band; 5–7 for a 2-D
    five-point pattern ``(-m, -1, 0, 1, m)``)."""
    offs = sorted({int(o) for o in offsets})
    c = len(offs)
    while len({o % c for o in offs}) < len(offs):
        c += 1
    return c


def materialize_csr(J: LinearOperator, offsets):
    """Colored probing → CSR ``(indptr, cols, vals)`` as numpy arrays, at
    O(nnz) memory: :func:`stencil_coloring`-many JVPs scattered into the
    pattern given by the flattened column ``offsets`` (e.g. ``(-1, 0, 1)``,
    or ``(-m, -1, 0, 1, m)`` for a row-major 5-point stencil on m columns).
    The true sparsity must lie inside the pattern, or entries alias."""
    offs = np.asarray(sorted({int(o) for o in offsets}))
    c = stencil_coloring(offs)
    flat_u = _flatten(J.u)
    n = flat_u.numel()
    outs = _probe(J, _striped_probes(flat_u, c), J.u).cpu().numpy()  # (c, M)

    i = np.arange(n)
    cols2d = i[:, None] + offs[None, :]                    # (n, k) pattern columns
    valid = (cols2d >= 0) & (cols2d < n)
    vals2d = outs[np.where(valid, cols2d, 0) % c, i[:, None]]
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(valid.sum(axis=1))
    return indptr, cols2d[valid].astype(np.int64), vals2d[valid]

"""Vector primitives over solver states.

Counterpart of ``newtonkrylov_tpu/tree.py``.  A state is a tensor or a
tuple (or dict) of tensors (in practice a
:class:`~newtonkrylov_tpu_torch.df32.DF` pair); these helpers map over its
tensor leaves and keep each leaf's dtype and device.  Global reductions (:func:`tree_vdot`, :func:`tree_norm`) are the
points a vector space may re-weight or all-reduce — see
:mod:`newtonkrylov_tpu_torch.spaces`.
"""

from __future__ import annotations

import torch

__all__ = [
    "tree_map",
    "tree_leaves",
    "tree_vdot",
    "tree_norm",
    "tree_add",
    "tree_sub",
    "tree_axpy",
    "tree_axpby",
    "tree_zeros_like",
    "tree_ones_like",
    "tree_where",
    "tree_size",
    "tree_dtype",
    "tree_scale",
    "tree_stack_like",
    "tree_get_row",
    "tree_set_row",
    "tree_rows",
    "tree_basis_combine",
    "tree_project_rows",
]


def tree_map(fn, x, *rest):
    """Apply ``fn`` leafwise over congruent states (tensors, tuples, named
    tuples or dicts)."""
    if isinstance(x, tuple):
        vals = [tree_map(fn, *ls) for ls in zip(x, *rest)]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, dict):
        return {k: tree_map(fn, x[k], *(r[k] for r in rest)) for k in sorted(x)}
    return fn(x, *rest)


def tree_leaves(x) -> list:
    """The leaves in order: tuples by position, dicts by sorted key (the
    JAX package's order)."""
    if isinstance(x, tuple):
        return [leaf for part in x for leaf in tree_leaves(part)]
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in tree_leaves(x[k])]
    return [x]


def tree_vdot(x, y):
    """<x, y> summed over every leaf (conjugating x, as ``jnp.vdot``)."""
    parts = [torch.vdot(a.reshape(-1), b.reshape(-1))
             for a, b in zip(tree_leaves(x), tree_leaves(y))]
    return torch.stack(parts).sum() if len(parts) > 1 else parts[0]


def tree_norm(x):
    return torch.sqrt(tree_vdot(x, x).real)


def tree_add(x, y):
    return tree_map(torch.add, x, y)


def tree_sub(x, y):
    return tree_map(torch.sub, x, y)


def tree_axpy(a, x, y):
    """y + a*x."""
    return tree_map(lambda xl, yl: yl + a * xl, x, y)


def tree_axpby(a, x, b, y):
    """a*x + b*y."""
    return tree_map(lambda xl, yl: a * xl + b * yl, x, y)


def tree_scale(a, x):
    """a*x."""
    return tree_map(lambda l: a * l, x)


def tree_zeros_like(x):
    return tree_map(torch.zeros_like, x)


def tree_ones_like(x):
    return tree_map(torch.ones_like, x)


def tree_where(pred, x, y):
    """Select whole state x or y on a scalar predicate."""
    return tree_map(lambda xl, yl: torch.where(pred, xl, yl), x, y)


def tree_size(x) -> int:
    return sum(leaf.numel() for leaf in tree_leaves(x))


def tree_dtype(x) -> torch.dtype:
    """dtype of the state (solvers assume a homogeneous state)."""
    dt = tree_leaves(x)[0].dtype
    for leaf in tree_leaves(x)[1:]:
        dt = torch.promote_types(dt, leaf.dtype)
    return dt


# -- Stacked Krylov bases --------------------------------------------------
#
# A basis of (at most) m states is the same state with a leading axis of
# length m on every leaf: each basis vector is contiguous, and the
# Gram–Schmidt projections against the basis are one matrix–vector product
# per leaf.


def tree_stack_like(x, m: int):
    """Zero-initialised stacked basis: every leaf gains a leading axis m."""
    return tree_map(lambda l: l.new_zeros((m,) + tuple(l.shape)), x)


def tree_get_row(V, k: int):
    """Basis vector k as a plain state (a view of the basis)."""
    return tree_map(lambda l: l[k], V)


def tree_set_row(V, k: int, x):
    """Write state x into row k of V, in place (the JAX package returns an
    updated copy; the port updates the basis it allocated once), and
    return V."""
    def put(vl, xl):
        vl[k] = xl
        return vl

    return tree_map(put, V, x)


def tree_rows(V, stop: int):
    """Rows [0, stop) of a stacked basis (a view)."""
    return tree_map(lambda l: l[:stop], V)


def tree_basis_combine(V, coeffs):
    """Σ_j coeffs[j]·V[j], one matrix–vector product per leaf; coeffs has
    one entry per row of V."""
    def comb(l):
        m = l.shape[0]
        return torch.mv(l.reshape(m, -1).t(), coeffs.to(l.dtype)).reshape(l.shape[1:])

    return tree_map(comb, V)


def tree_project_rows(V, w):
    """All inner products <V[j], w> at once, shape (m,): one product per
    leaf, the classical Gram–Schmidt projection."""
    def proj(vl, wl):
        return torch.mv(vl.reshape(vl.shape[0], -1).conj(), wl.reshape(-1))

    parts = [proj(vl, wl) for vl, wl in zip(tree_leaves(V), tree_leaves(w))]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out

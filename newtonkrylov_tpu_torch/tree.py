"""Vector primitives over solver states.

Counterpart of :mod:`newtonkrylov_tpu.tree`.  A state is a tensor or a tuple
of tensors (in practice a :class:`~newtonkrylov_tpu_torch.df32.DF` pair);
these helpers map over its tensor leaves and keep each leaf's dtype and
device.  Global reductions (:func:`tree_vdot`, :func:`tree_norm`) are the
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
    "tree_sub",
    "tree_axpy",
    "tree_zeros_like",
    "tree_where",
    "tree_size",
    "tree_dtype",
]


def tree_map(fn, x, *rest):
    """Apply ``fn`` leafwise over congruent states (tensors or tuples)."""
    if isinstance(x, tuple):
        vals = [tree_map(fn, *ls) for ls in zip(x, *rest)]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return fn(x, *rest)


def tree_leaves(x) -> list:
    if isinstance(x, tuple):
        return [leaf for part in x for leaf in tree_leaves(part)]
    return [x]


def tree_vdot(x, y):
    """<x, y> summed over every leaf (conjugating x, as ``jnp.vdot``)."""
    parts = [torch.vdot(a.reshape(-1), b.reshape(-1))
             for a, b in zip(tree_leaves(x), tree_leaves(y))]
    return torch.stack(parts).sum() if len(parts) > 1 else parts[0]


def tree_norm(x):
    return torch.sqrt(tree_vdot(x, x).real)


def tree_sub(x, y):
    return tree_map(torch.sub, x, y)


def tree_axpy(a, x, y):
    """y + a*x."""
    return tree_map(lambda xl, yl: yl + a * xl, x, y)


def tree_zeros_like(x):
    return tree_map(torch.zeros_like, x)


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

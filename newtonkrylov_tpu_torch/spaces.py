"""Vector spaces: where the solvers' reductions live.

Counterpart of ``newtonkrylov_tpu/spaces.py``.  Solvers take a ``space`` and
perform every dot product and norm through it; elementwise updates stay raw
tensor ops.

* :class:`EuclideanSpace` — plain reductions over every entry.
* :class:`MaskedSpace` — reductions weighted by a 0/1 interior mask, so the
  ghost cells of a ghost-carrying layout never contribute.
* :class:`ShardedSpace` — the local (masked or plain) reduction of a rank's
  block followed by one ``all_reduce`` over the mesh axes: the point where a
  sharded solve's ranks agree (:mod:`~newtonkrylov_tpu_torch.halo`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Sequence

import torch

from .exportable import exporting
from .tree import tree_dtype, tree_map, tree_norm, tree_project_rows, tree_vdot
from .utils import distributed as _dist

__all__ = ["VectorSpace", "EuclideanSpace", "MaskedSpace", "ShardedSpace",
           "default_space"]


class VectorSpace:
    """Reduction protocol for solver inner products."""

    def dot(self, x, y):
        raise NotImplementedError

    def norm(self, x):
        return torch.sqrt(self.dot(x, x).real)

    def dot2(self, x1, y1, x2, y2):
        """(<x1,y1>, <x2,y2>) as one (2,)-reduction (alias of dot_stack)."""
        return self.dot_stack([(x1, y1), (x2, y2)])

    def dot_stack(self, pairs):
        """k independent inner products as one stacked (k,) tensor."""
        return torch.stack([self.dot(x, y) for x, y in pairs])

    def mask_tree(self, x):
        """Zero out entries that do not belong to the space (ghost cells)."""
        return x

    def project_rows(self, V, w):
        """<V[j], w> for all rows j of a stacked basis → (m,) vector."""
        raise NotImplementedError

    def reduce_rows(self, h):
        """Complete a vector of locally accumulated inner products (blocked
        orthogonalization): the identity on one device."""
        return h

    def size_multiplier(self):
        """Global size = local tree_size × this (1 without sharding)."""
        return 1


@dataclasses.dataclass(frozen=True)
class EuclideanSpace(VectorSpace):
    """Plain ℓ² space over all entries."""

    def dot(self, x, y):
        return tree_vdot(x, y)

    def norm(self, x):
        return tree_norm(x)

    def project_rows(self, V, w):
        return tree_project_rows(V, w)


@dataclasses.dataclass(frozen=True)
class MaskedSpace(VectorSpace):
    """Interior-masked ℓ² space.

    ``mask`` is congruent with the state: 1 on the interior, 0 on ghosts.
    """

    mask: Any
    # The mask cast to each operand dtype it has met: mixed-precision solves
    # run f32 Krylov vectors against an f64-state mask, and casting once
    # keeps a full-array cast out of every reduction of the Krylov loop.
    _cast: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    def _mask_as(self, dtype):
        m = self._cast.get(dtype)
        if m is None:
            m = tree_map(lambda l: l.to(dtype), self.mask)
            if not exporting():  # a traced cast stays out of the cache
                self._cast[dtype] = m
        return m

    def dot(self, x, y):
        return tree_vdot(self.mask_tree(x), y)

    def project_rows(self, V, w):
        return tree_project_rows(V, self.mask_tree(w))

    def mask_tree(self, x):
        return tree_map(torch.mul, self._mask_as(tree_dtype(x)), x)


@dataclasses.dataclass(frozen=True)
class ShardedSpace(VectorSpace):
    """Masked or plain space on a rank's block + ``all_reduce`` over mesh
    axes: the distributed reduction point.

    ``axis_names`` are the mesh axes the state is sharded over; every scalar
    reduction is completed by one all-reduce over their group (over all
    axes of a mesh, the whole group: one collective, not one per axis).
    ``dot_stack`` (and ``dot2``) stack their local dots and complete them in
    one all-reduce, as the JAX package's single ``psum``.  ``mask`` is None
    (the blocks hold only interior) or the block's interior mask.  ``mesh``
    defaults to the current mesh (``halo.make_mesh``).
    """

    axis_names: Sequence[str]
    mask: Any = None
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    @functools.cached_property
    def _local(self):
        return (MaskedSpace(self.mask) if self.mask is not None
                else EuclideanSpace())

    def _sum(self, x):
        return _dist.all_reduce(x, tuple(self.axis_names), "sum", self.mesh)

    def dot(self, x, y):
        return self._sum(self._local.dot(x, y))

    def project_rows(self, V, w):
        return self._sum(self._local.project_rows(V, w))

    def dot_stack(self, pairs):
        loc = self._local
        return self._sum(torch.stack([loc.dot(x, y) for x, y in pairs]))

    def mask_tree(self, x):
        return self._local.mask_tree(x)

    def reduce_rows(self, h):
        return self._sum(h)

    def size_multiplier(self):
        mult = 1
        for ax in self.axis_names:
            mult *= _dist.axis_size(ax, self.mesh)
        return mult


def default_space() -> VectorSpace:
    return EuclideanSpace()
